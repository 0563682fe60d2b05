"""Motion-track (T2MS) evaluation CLI (counterpart of
t2ms_tpu/cli/myevaluation.py).

Reference: myevaluation.py __main__ (:285-339) — per-sample x per-run loops
over saved x_t_sample_{i}.npy / x_1_sample_{i}.npy, per-row min-max
normalization (:29-35), full metric list [MSE,WAPE,MRR,CRPS,C-FID,ED,ACD,
SD,KD,DTW] (:287-288), summary averaging into JSON (:323-337). The flags,
paths and JSON file are the JAX CLI's.

    python -m t2ms_tpu_torch.cli.myevaluation --dataset_name benchpress ...

fits C-FID's TS2Vec on the card; ``--device cpu`` (or ``main(argv,
device="cpu")``) fits it on the CPU. The metrics run on the host.
"""

from __future__ import annotations

import argparse
import datetime
import os

import numpy as np

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.config import generation_dir, get_cfg
from t2ms_tpu_torch.evaluate import (calculate_acd, calculate_crps,
                                     calculate_dtw, calculate_ed,
                                     calculate_fid, calculate_kd,
                                     calculate_mrr, calculate_mse,
                                     calculate_sd, calculate_wape,
                                     initialize_ts2vec, normalize_per_row)
from t2ms_tpu_torch.utils.logging import (show_with_end_divider,
                                          show_with_start_divider,
                                          write_json_data)


def _method_list(raw):
    if isinstance(raw, list):
        return raw
    return [m.strip() for m in raw.strip("[]").split(",")]


def evaluate_data(args, ori_data, gen_data, index, result):
    """Per-sample metric computation over stacked runs
    (reference :228-283). ori/gen: (runs, D, T).

    Layout fix vs the reference (documented deviation): the reference
    passes (runs, D, T) stacks straight into metrics written for NTD
    arrays and would crash on MRR/CRPS (calculate_mrr expects 4-D,
    myevaluation.py:45-47). Here every metric sees the documented NTD
    layout, and the ``run_time`` runs form the GENERATION axis of a
    (1, T, D, G) stack for the multi-run metrics (MRR/CRPS) — the same
    convention the T2S track already uses (evaluation.py:302-314), so
    real cross-run variation drives them."""
    show_with_start_divider(f"Evalution with settings:{args}")
    methods = _method_list(args.method_list)
    if gen_data is None or ori_data.shape != gen_data.shape:
        # skip THIS sample but keep the accumulated per-sample results —
        # returning None here would wipe `result` and crash on the next
        # sample's item assignment
        show_with_end_divider("Error: Generated data mismatch.")
        return result
    result[index] = {}
    ntd_ori = np.transpose(ori_data, (0, 2, 1))          # (G, T, D)
    ntd_gen = np.transpose(gen_data, (0, 2, 1))
    # multi-run stack: one observed sample, runs on the last axis
    obs = ntd_ori[:1]                                    # (1, T, D)
    gen_runs = np.transpose(ntd_gen, (1, 2, 0))[None]    # (1, T, D, G)
    if "C-FID" in methods:
        # the extractor trains on the VARIED generated runs — exactly the
        # stack the reference fits on (its swapped 'ori_data', :249).
        # Training on ntd_ori here would fit TS2Vec to G IDENTICAL
        # ground-truth copies (zero covariance), degenerating the metric.
        # Fréchet distance itself is symmetric, so only the training
        # stack matters.
        fid_model = initialize_ts2vec(ntd_gen, args.device)
        r1 = fid_model.encode(ntd_ori.astype(np.float32),
                              encoding_window="full_series")
        r2 = fid_model.encode(ntd_gen.astype(np.float32),
                              encoding_window="full_series")
        result[index]["C-FID"] = calculate_fid(r1, r2)
    if "MSE" in methods:
        result[index]["MSE"] = calculate_mse(ntd_ori, ntd_gen)
    if "WAPE" in methods:
        result[index]["WAPE"] = calculate_wape(ntd_ori, ntd_gen)
    if "MRR" in methods:
        result[index]["MRR"] = calculate_mrr(obs, gen_runs)
    if "CRPS" in methods:
        result[index]["CRPS"] = calculate_crps(obs, gen_runs)
    if "ED" in methods:
        result[index]["ED"] = calculate_ed(ntd_ori, ntd_gen)
    if "ACD" in methods:
        result[index]["ACD"] = calculate_acd(ntd_ori, ntd_gen)
    if "SD" in methods:
        result[index]["SD"] = calculate_sd(ntd_ori, ntd_gen)
    if "KD" in methods:
        result[index]["KD"] = calculate_kd(ntd_ori, ntd_gen)
    if "DTW" in methods:
        result[index]["DTW"] = calculate_dtw(ntd_ori, ntd_gen)
    return result


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate T2MS generations")
    p.add_argument("--method_list", type=str, default="MSE,WAPE,DTW")
    p.add_argument("--save_path", type=str,
                   default="./results/denoiser_results")
    p.add_argument("--config", type=str, default="config.yaml")
    p.add_argument("--dataset_name", type=str, default="benchpress")
    p.add_argument("--cfg_scale", type=float, default=3)
    p.add_argument("--total_step", type=int, default=100)
    p.add_argument("--run_time", type=int, default=10)
    p.add_argument("--n_samples", type=int, default=10)
    p.add_argument("--device", type=str, default=None,
                   help="TS2Vec's device (default: CUDA)")
    args = p.parse_args(argv)
    args = get_cfg(args)
    args.model_name = (f"{args.backbone}_{args.denoiser}_"
                       f"{args.dataset_name}_{args.cfg_scale}_"
                       f"{args.total_step}")
    args.generation_save_path = generation_dir(
        args.save_path, args.backbone, args.denoiser, args.dataset_name,
        args.cfg_scale, args.total_step)
    args.evaluation_save_path = os.path.join(args.save_path, "evaluation",
                                             args.model_name)
    return args


def main(argv=None, device=None):
    """Parse ``argv`` and evaluate; TS2Vec runs on ``device``, else
    ``--device``, else CUDA (raises on a machine with no card). Returns the
    result dict (per sample, and the summary)."""
    args = get_args(argv)
    args.device = resolve_device(device if device is not None
                                 else args.device)
    result = {}
    for sample in range(args.n_samples):
        x_1_list, x_t_list = [], []
        for j in range(args.run_time):
            run_dir = os.path.join(args.generation_save_path, f"run_{j}")
            xt_path = os.path.join(run_dir, f"x_t_sample_{sample}.npy")
            x1_path = os.path.join(args.generation_save_path,
                                   f"x_1_sample_{sample}.npy")
            if not (os.path.exists(xt_path) and os.path.exists(x1_path)):
                continue
            x_t = normalize_per_row(np.load(xt_path))
            x_1 = normalize_per_row(np.load(x1_path))
            x_t_list.append(x_t)
            x_1_list.append(x_1)
        if not x_t_list:
            continue
        print(f"ori_data shape:{np.array(x_1_list).shape}, "
              f"gen_data shape:{np.array(x_t_list).shape}")
        # Deviation from the reference call (myevaluation.py:331), which
        # passes the GENERATED runs as ori_data and the repeated ground
        # truth as gen_data — making the generation axis degenerate
        # (identical truth copies) so MRR/CRPS are blind to cross-run
        # variation. Here truth is the observation and the runs form the
        # generation axis.
        result = evaluate_data(args, np.array(x_1_list), np.array(x_t_list),
                               sample, result)

    if isinstance(result, dict) and result:
        summary = {}
        for key in result:
            for metric, value in result[key].items():
                summary[metric] = summary.get(metric, 0) + value
        for metric in summary:
            summary[metric] = summary[metric] / len(result)
        result["summary"] = summary
        now = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        out = os.path.join(
            args.evaluation_save_path,
            f"{args.model_name}_{args.dataset_name}_{now}.json")
        write_json_data(result, out)
        print(f"Evaluation denoiser_results saved to {out}.")
    show_with_end_divider(f"Evaluation done. Results:{result}.")
    return result


if __name__ == "__main__":
    main()
