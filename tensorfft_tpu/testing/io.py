"""Result/benchmark/accuracy file writers.

Mirror of the reference FileWriter.h: result dumps as ``x RE IM`` lines
(:19-169), accuracy tables (``Accuracy_Test.dat``, :206-225), benchmark tables
(``BenchResults.dat``, :271-310), and a log writer (:192-203).  The same
text formats are kept (eyeball/diff parity with the reference workflow) plus
JSON variants for tooling.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = [
    "write_results_to_file",
    "read_results_from_file",
    "write_result_batch_to_files",
    "read_result_batch_from_files",
    "compare_result_files",
    "compare_many_result_files",
    "write_accuracy_table",
    "write_bench_table",
    "write_log",
]


def write_results_to_file(path, re, im):
    """``x RE IM`` per line (FileWriter.h:19-76 analog), split planar input."""
    re = np.asarray(re).ravel()
    im = np.asarray(im).ravel()
    with open(path, "w") as f:
        for x in range(len(re)):
            f.write(f"{x} {re[x]:.17g} {im[x]:.17g}\n")


def read_results_from_file(path):
    """Parse an ``x RE IM`` file back to split planar arrays
    (AccuracyCalculator.h:150-658 file-comparison analog)."""
    xs, res, ims = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            xs.append(int(parts[0]))
            res.append(float(parts[1]))
            ims.append(float(parts[2]))
    order = np.argsort(xs)
    return np.asarray(res)[order], np.asarray(ims)[order]


def write_result_batch_to_files(prefix, re, im):
    """One ``x RE IM`` file per batch element (FileWriter.h:78-169 analog).

    ``re``/``im`` are (batch, n) planes; files are ``<prefix>_<i>.dat``.
    Returns the list of paths written.
    """
    re = np.asarray(re)
    im = np.asarray(im)
    if re.ndim == 1:
        re = re[None]
        im = im[None]
    paths = []
    for i in range(re.shape[0]):
        p = f"{prefix}_{i}.dat"
        write_results_to_file(p, re[i], im[i])
        paths.append(p)
    return paths


def read_result_batch_from_files(paths):
    """Stack per-element result files back into (batch, n) planes."""
    res, ims = [], []
    for p in paths:
        r, i = read_results_from_file(p)
        res.append(r)
        ims.append(i)
    return np.stack(res), np.stack(ims)


def compare_result_files(path_a, path_b):
    """Deviation between two ``x RE IM`` files
    (AccuracyCalculator.h:150-346 file-based comparison analog).

    Returns a testing.metrics.Deviation over the complex difference.
    """
    from tensorfft_tpu.testing.metrics import deviation

    a = read_results_from_file(path_a)
    b = read_results_from_file(path_b)
    if a[0].shape != b[0].shape:
        raise ValueError(
            f"length mismatch: {a[0].shape} vs {b[0].shape} "
            f"({path_a} vs {path_b})"
        )
    return deviation(a, b)


def compare_many_result_files(paths, reference_path):
    """Many-vs-one file comparison (AccuracyCalculator.h:349-658 analog).

    The reference harness compares each batch element's dump against one
    oracle dump; returns the list of per-file Deviations in input order.
    """
    return [compare_result_files(p, reference_path) for p in paths]


def write_accuracy_table(path, rows: Sequence[dict]):
    """Accuracy table (Accuracy_Test.dat analog, FileWriter.h:206-225).

    rows: dicts with fft_length/avg/sigma/max (extra keys land in the JSON
    sidecar).
    """
    with open(path, "w") as f:
        f.write("# fft_length avg_deviation sigma_deviation max_deviation\n")
        for r in rows:
            f.write(
                f"{r['fft_length']} {r['avg']:.8e} {r['sigma']:.8e} {r['max']:.8e}\n"
            )
    Path(str(path) + ".json").write_text(json.dumps(list(rows), indent=1))


def write_bench_table(path, rows: Sequence[dict]):
    """Benchmark table (BenchResults.dat analog, FileWriter.h:271-310)."""
    with open(path, "w") as f:
        f.write("# fft_length batch avg_time_us sigma_us gflops\n")
        for r in rows:
            f.write(
                f"{r['fft_length']} {r.get('batch', 1)} "
                f"{r['avg_time_us']:.3f} {r.get('sigma_us', 0.0):.3f} "
                f"{r.get('gflops', 0.0):.1f}\n"
            )
    Path(str(path) + ".json").write_text(json.dumps(list(rows), indent=1))


def write_log(path, messages: Sequence[str]):
    """Append log lines (FileWriter.h:192-203 analog)."""
    with open(path, "a") as f:
        for m in messages:
            f.write(m.rstrip("\n") + "\n")
