"""T2S evaluation CLI (counterpart of t2ms_tpu/cli/evaluation.py).

Reference: evaluation.py __main__ (:268-314): loads the generated .npy
arrays, computes MSE/WAPE (+C-FID via TS2Vec) via evaluate_data
(:210-266), then stacks the 10 runs for CRPS/MRR via evaluate_muldata
(:87-124); results to timestamped JSON under evaluation/{model_name}. The
flags, paths and JSON files are the JAX CLI's.

    python -m t2ms_tpu_torch.cli.evaluation --dataset_name ETTh1_24 ...

fits TS2Vec on the card; ``--device cpu`` (or ``main(argv,
device="cpu")``) fits it on the CPU. The metrics run on the host.
"""

from __future__ import annotations

import argparse
import datetime
import os

import numpy as np

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.config import generation_dir
from t2ms_tpu_torch.evaluate import (calculate_crps, calculate_fid,
                                     calculate_mrr, calculate_mse,
                                     calculate_wape, initialize_ts2vec)
from t2ms_tpu_torch.utils.logging import (show_with_end_divider,
                                          show_with_start_divider,
                                          write_json_data)


def _method_list(raw):
    if isinstance(raw, list):
        return raw
    return [m.strip() for m in raw.strip("[]").split(",")]


def _stamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def evaluate_data(args, ori_data, gen_data):
    """Single-run metrics over (N, D, T) arrays (reference :210-266)."""
    show_with_start_divider(f"Evalution with settings:{args}")
    methods = _method_list(args.method_list)
    if gen_data is None:
        show_with_end_divider("Error: Generated data not found.")
        return None
    if ori_data.shape != gen_data.shape:
        show_with_end_divider("Error: Generated data does not have the same "
                              "shape with original data.")
        return None
    result = {}
    ntd_ori = np.transpose(ori_data, (0, 2, 1))
    ntd_gen = np.transpose(gen_data, (0, 2, 1))
    if "C-FID" in methods:
        fid_model = initialize_ts2vec(ntd_ori, args.device)
        ori_repr = fid_model.encode(ntd_ori, encoding_window="full_series")
        gen_repr = fid_model.encode(ntd_gen, encoding_window="full_series")
        result["C-FID"] = calculate_fid(ori_repr, gen_repr)
    if "MSE" in methods:
        result["MSE"] = calculate_mse(ntd_ori, ntd_gen)
    if "WAPE" in methods:
        result["WAPE"] = calculate_wape(ntd_ori, ntd_gen)

    out = os.path.join(args.evaluation_save_path,
                       f"{args.model_name}_{args.dataset_name}_{_stamp()}"
                       f".json")
    write_json_data(result, out)
    print(f"Evaluation denoiser_results saved to {out}.")
    show_with_end_divider(f"Evaluation done. Results:{result}.")
    return result


def evaluate_muldata(args, ori_data, gen_data):
    """Multi-run metrics: CRPS/MRR over (N, T, D, G) (reference :87-124)."""
    show_with_start_divider(f"Evalution with settings:{args}")
    methods = _method_list(args.method_list)
    if gen_data is None:
        show_with_end_divider("Error: Generated data not found.")
        return None
    result = {}
    if "CRPS" in methods:
        result["CRPS"] = calculate_crps(ori_data, gen_data)
    if "MRR" in methods:
        result["MRR"] = calculate_mrr(ori_data, gen_data)
    out = os.path.join(
        args.evaluation_save_path,
        f"{args.model_name}_{args.dataset_name}_{_stamp()}_multi.json")
    write_json_data(result, out)
    show_with_end_divider(f"Evaluation done. Results:{result}.")
    return result


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate generated series")
    p.add_argument("--method_list", type=str, default="MSE,WAPE,MRR")
    p.add_argument("--save_path", type=str,
                   default="./results/denoiser_results")
    p.add_argument("--dataset_name", type=str, default="ETTh1_96")
    p.add_argument("--backbone", type=str, default="flowmatching")
    p.add_argument("--denoiser", type=str, default="DiT")
    p.add_argument("--cfg_scale", type=float, default=9.0)
    p.add_argument("--total_step", type=int, default=10)
    p.add_argument("--device", type=str, default=None,
                   help="TS2Vec's device (default: CUDA)")
    args = p.parse_args(argv)
    args.data_length = (args.dataset_name.split("_")[-1]
                        if args.dataset_name != "SUSHI" else 2048)
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
    ``--device``, else CUDA (raises on a machine with no card)."""
    args = get_args(argv)
    args.device = resolve_device(device if device is not None
                                 else args.device)
    x_1 = np.load(os.path.join(args.generation_save_path, "run_0", "x_1.npy"))
    x_t = np.load(os.path.join(args.generation_save_path, "x_t.npy"))
    x_1 = np.transpose(x_1, (0, 2, 1))
    x_t = np.transpose(x_t, (0, 2, 1))
    single = evaluate_data(args, ori_data=x_1, gen_data=x_t)

    all_x_t = []
    for run_index in range(10):
        run_dir = os.path.join(args.generation_save_path, f"run_{run_index}")
        x_1 = np.load(os.path.join(run_dir, "x_1.npy"))
        x_t = np.load(os.path.join(run_dir, "x_t.npy"))
        all_x_t.append(np.expand_dims(x_t, axis=-1))
    x_t_all = np.concatenate(all_x_t, axis=-1)
    multi = evaluate_muldata(args, ori_data=x_1, gen_data=x_t_all)
    return single, multi


if __name__ == "__main__":
    main()
