"""Real-vs-real metric experiment CLI (counterpart of
t2ms_tpu/cli/metrics_experiment.py; host code, as in JAX).

Reference: evaluate/metrics.py __main__ (:290-370) — cross-compares
recordings (merged_{i}.txt comma-separated frame rows) between a reference
subject and a rival subject across preprocessing variants, computing
MSE/WAPE/correlational-score/DTW/shift-correlation and rendering error-bar
plots per metric.

Generalized: --root/--rival_root point at directories containing
``<variant>/merged_{i}.txt`` (variant dirs like ``filtered_norm``); when
the rival equals the root, self-pairs are excluded as in the reference.
DTW runs on the native C++ kernel. Where matplotlib is absent the
error-bar plots are skipped with one line; the scores are returned either
way.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

from t2ms_tpu_torch.evaluate.dtw import dtw_native
from t2ms_tpu_torch.evaluate.metrics import (calculate_correlational_score,
                                             calculate_mse, calculate_wape,
                                             min_max_normalize_columns,
                                             sequence_correlation)


def _load_merged(path: str) -> np.ndarray:
    with open(path, encoding="utf-8") as f:
        lines = f.read().strip().split("\n")
    return min_max_normalize_columns(
        np.array([[float(v) for v in line.split(",")] for line in lines]))


def _plot_errorbars(scores: np.ndarray, output_path: str, name: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    mean = scores.mean(axis=0)
    std = scores.std(axis=0)
    idx = np.arange(len(mean))
    plt.clf()
    plt.figure(figsize=(10, 6))
    plt.errorbar(idx, mean, yerr=std, fmt="o-", label=name, capsize=5)
    plt.xlabel("Generated File Index (merged_i.txt)")
    plt.ylabel("Score")
    plt.title("metrics on same subject")
    plt.legend()
    plt.grid(True)
    plt.tight_layout()
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    plt.savefig(output_path)
    plt.close("all")


def run_experiment(root: str, rival_root: str, out_dir: str,
                   variants=("filtered_norm",), n_files: int = 10):
    self_compare = os.path.abspath(root) == os.path.abspath(rival_root)
    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        print("error-bar plots skipped: matplotlib is not installed")
    results = {}
    for variant in variants:
        per_metric = {m: [] for m in ("mse", "wape", "correlational_score",
                                      "dtw", "sequence_correlation")}
        cache = {}           # each file parses once, not once per rival

        def load(path):
            if path not in cache:
                cache[path] = _load_merged(path)
            return cache[path]

        for i in range(1, n_files + 1):
            ref_path = os.path.join(root, variant, f"merged_{i}.txt")
            if not os.path.exists(ref_path):
                continue
            ori = load(ref_path)
            row = {m: [] for m in per_metric}
            for j in range(1, n_files + 1):
                if self_compare and j == i:
                    continue
                cand = os.path.join(rival_root, variant, f"merged_{j}.txt")
                if not os.path.exists(cand):
                    continue
                gen = load(cand)
                ob, gb = ori[None], gen[None]
                L = min(ori.shape[0], gen.shape[0])
                row["mse"].append(calculate_mse(ob[:, :L], gb[:, :L]))
                row["wape"].append(calculate_wape(ob[:, :L], gb[:, :L]))
                row["correlational_score"].append(
                    calculate_correlational_score(ob[:, :L], gb[:, :L]))
                row["dtw"].append(dtw_native(ori, gen))
                _, md = sequence_correlation(ori, gen)
                row["sequence_correlation"].append(md)
            for m in per_metric:
                if row[m]:
                    per_metric[m].append(row[m])
        for m, rows in per_metric.items():
            if not rows:
                continue
            arr = np.asarray(rows)
            results[(variant, m)] = arr
            if plots:
                _plot_errorbars(arr, os.path.join(out_dir, m,
                                                  f"{variant}_result.jpg"),
                                m)
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", type=str, required=True,
                   help="reference subject directory")
    p.add_argument("--rival_root", type=str, default=None,
                   help="rival subject directory (default: root itself)")
    p.add_argument("--out_dir", type=str, default="./metrics_test")
    p.add_argument("--variants", type=str,
                   default="filtered_delta_norm,filtered_delta2_norm,"
                           "filtered_delta_square_norm,filtered_norm")
    p.add_argument("--n_files", type=int, default=10)
    args = p.parse_args(argv)
    rival = args.rival_root or args.root
    res = run_experiment(args.root, rival, args.out_dir,
                         tuple(args.variants.split(",")), args.n_files)
    for (variant, metric), arr in res.items():
        print(f"{variant} {metric}: mean={arr.mean():.4f} "
              f"std={arr.std():.4f}")


if __name__ == "__main__":
    main()
