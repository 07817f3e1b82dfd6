"""chip_smoke.py: every phase at a tiny size on the CPU, the refusal of any
platform but the GPU, and the phases at a mid size on the card (gpu marker).

The four-card phases run here on four of the eight virtual CPU devices.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def test_signal_batch_rows_differ():
    re, im = cs.signal_batch(64, 9)
    assert re.shape == im.shape == (9, 64)
    # Row b is base b % 4 shifted by b: all rows distinct, rows 0 and 4
    # share a base but not a shift.
    assert len({row.tobytes() for row in re}) == 9
    np.testing.assert_array_equal(re[4], np.roll(re[0], -4))


@pytest.mark.parametrize("precision,max_limit", [("bfloat16", None),
                                                 ("float32", 1e-4)])
def test_phase_c2c_tiny(precision, max_limit):
    r = cs.phase_c2c(256, 8, precision, max_limit=max_limit, memory=True)
    assert r["route"] == "staged" and set(r) == {"route", "staged", "xla"}
    assert all(r[s]["avg"] <= 1e-3 for s in ("staged", "xla"))


def test_phase_roundtrip_tiny():
    r = cs.phase_roundtrip(256, 8)
    assert r["rel_mean"] <= 1e-2


def test_phase_rfft_tiny():
    r = cs.phase_rfft(1024, 4)
    assert r["rel_mean"] <= 1e-4


def test_phase_conv2d_tiny():
    r = cs.phase_conv2d(32, 64)
    assert r["rel_max"] <= 1e-4


def test_phase_batch_sharded_tiny():
    r = cs.phase_batch_sharded(256, 16, 4)
    assert r["rel_jnp"] <= 1e-4


def test_phase_pencil_1d_tiny():
    r = cs.phase_pencil_1d(1 << 12, 4)
    assert set(r) == {"1", "auto"}


def test_phase_pencil_3d_tiny():
    r = cs.phase_pencil_3d(16, 4)
    assert set(r) == {"slab", "2x2"}


def test_phase_poisson_tiny():
    r = cs.phase_poisson(16, 4)
    assert r["rel_fp64"] <= 1e-4


def test_check_raises_phase_failed():
    with pytest.raises(cs.PhaseFailed, match="boom"):
        cs.check(False, "boom")
    cs.check(True, "fine")


def test_run_phases_reports_every_failure(capsys):
    def bad():
        raise ValueError("nope")

    with pytest.raises(cs.PhaseFailed, match=r"\['b', 'd'\]"):
        cs.run_phases([("a", lambda: 1), ("b", bad), ("c", lambda: 2),
                       ("d", bad)])
    out = capsys.readouterr().out
    assert out.count("FAILED") == 2 and "[phase] c" in out


def test_main_refuses_cpu(capsys):
    assert cs.main([]) == 2
    assert cs.main(["--four"]) == 2
    out, err = capsys.readouterr()
    assert "needs a GPU" in err
    assert not [l for l in out.splitlines() if l.startswith("{")]


def test_script_alone_fails(tmp_path):
    # Without the library beside it the script fails and prints no result.
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]


def test_phase_tables_name_every_phase():
    names = [name for name, _ in cs.ONE_CARD]
    assert len(names) == 6 and len(set(names)) == 6
    assert len(cs.four_card_phases()) == 4


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
def test_gpu_route_and_peaks(gpu_device):
    import tensorfft_tpu as tfft
    from tensorfft_tpu.utils import device_spec

    assert tfft.route(16384) is tfft.Strategy.XLA
    assert tfft.plan_works_on_device(tfft.create_plan(16384), gpu_device)[0]
    assert device_spec(gpu_device).platform == "gpu"


@pytest.mark.gpu
def test_gpu_phases_mid_size(gpu_device):
    del gpu_device
    r = cs.phase_c2c(4096, 256, "bfloat16", memory=True)
    assert r["route"] == "xla"
    cs.phase_c2c(4096, 256, "float32", max_limit=1e-4)
    cs.phase_roundtrip(4096, 64)
    cs.phase_rfft(1 << 16, 4)
    cs.phase_conv2d(512, 512)
    json.dumps(r)
