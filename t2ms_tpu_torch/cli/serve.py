"""Online generation server (counterpart of t2ms_tpu/cli/serve.py).

Loads the bundle ``cli.infer`` loads (LA-VAE + denoiser checkpoints,
reference ``.pth`` imports included) and exposes the dynamic-batching
``ServingEngine`` over a stdlib HTTP/JSON API:

    POST /generate  {"text_embedding": [..E floats..],
                     "out_length": L,            # admitted bucket
                     "cfg_scale": 7.0,           # optional, per request
                     "seed": 123}                # optional
        -> {"series": [..], "seed": .., "out_length": .., "cfg_scale": ..,
            "latency_s": .., "batch_size": .., "batched_with": ..}
    GET  /stats    -> engine throughput/latency/padding counters
    GET  /healthz  -> {"ok": true, "buckets": [..], "tiers": [..], ...}

    python -m t2ms_tpu_torch.cli.serve --dataset_name ETTh1_24 \\
        --checkpoint_id 1 --buckets 24,96 --tiers 1,16,64 --port 8476

serves on the card; ``main(argv, device="cpu")`` serves the plain path on
the CPU. The handler threads only stage numpy and wait on futures: the
engine's dispatcher thread owns the device. Ctrl-C closes the server,
drains the engine and exits 0.

Under ``torchrun`` with WORLD_SIZE > 1, rank 0 serves HTTP with a
data-parallel engine and every other rank runs ``serve_worker`` until the
engine closes; each tier that the world size divides is split over all
ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.cli.infer import load_models
from t2ms_tpu_torch.config import denoiser_ckpt_dir, t2s_pretrained_dir
from t2ms_tpu_torch.parallel.mesh import init_from_env, is_main
from t2ms_tpu_torch.serving import EngineOverloaded, ServingEngine
from t2ms_tpu_torch.serving.engine import serve_worker
from t2ms_tpu_torch.training.scaling import setup_scaling


def get_args(argv=None):
    p = argparse.ArgumentParser(description="T2S/T2MS generation server")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8476)
    p.add_argument("--backbone", type=str, default="flowmatching")
    p.add_argument("--denoiser", type=str, default="DiT")
    p.add_argument("--solver", type=str, default="euler",
                   choices=["euler", "heun", "midpoint", "ddim"])
    p.add_argument("--total_step", type=int, default=100)
    p.add_argument("--sample_steps", type=int, default=0,
                   help="ddim only: sampling steps over the --total_step "
                        "schedule (0 = total_step)")
    p.add_argument("--cfg_scale", type=float, default=7.0,
                   help="default guidance scale (overridable per request)")
    p.add_argument("--buckets", type=str, default="96",
                   help="comma-separated admitted out_lengths; each costs "
                        "len(tiers) warmup calls")
    p.add_argument("--tiers", type=str, default="1,4,16",
                   help="comma-separated fixed batch sizes")
    p.add_argument("--max_wait_ms", type=float, default=20.0,
                   help="deadline before a non-full batch launches")
    p.add_argument("--max_pending", type=int, default=4096,
                   help="admission control: queued requests beyond this "
                        "get HTTP 503 instead of growing host memory "
                        "(0 = unbounded)")
    p.add_argument("--warmup", type=lambda s: s not in ("0", "False"),
                   default=True, help="run every (bucket, tier) once at "
                                      "startup")
    p.add_argument("--save_path", type=str,
                   default="./results/denoiser_results")
    p.add_argument("--dataset_name", type=str, default="exchangerate_24")
    p.add_argument("--checkpoint_id", type=int, default=19999)
    p.add_argument("--checkpoint_file", type=str, default="")
    p.add_argument("--vae_file", type=str, default="")
    p.add_argument("--latent_grid", type=int, default=30)
    p.add_argument("--text_emb_dim", type=int, default=128)
    p.add_argument("--compute_dtype", type=str, default="bf16",
                   choices=["f32", "float32", "bf16", "bfloat16"],
                   help="denoiser activation dtype; bf16 is the serving "
                        "config")
    args = p.parse_args(argv)
    args.usepretrainedvae = True
    model_root = args.dataset_name.split("_")[0]
    args.checkpoint_path = args.checkpoint_file or os.path.join(
        denoiser_ckpt_dir(args.save_path, args.backbone, args.denoiser,
                          model_root),
        f"model_{args.checkpoint_id}")
    args.pretrained_model_path = args.vae_file or os.path.join(
        t2s_pretrained_dir(model_root), "final_model")
    return args


def load_bundle(args, device=None):
    """(vae, denoiser, buckets): both models on ``device`` (None = CUDA),
    loaded as ``cli.infer`` loads them, minus the dataset."""
    buckets = [int(b) for b in str(args.buckets).split(",")]
    vae, denoiser = load_models(args, resolve_device(device), max(buckets))
    return vae, denoiser, buckets


class _Handler(BaseHTTPRequestHandler):
    engine: ServingEngine = None
    meta: dict = None

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *a):  # quiet per-request stderr spam
        pass

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, dict(ok=True, **self.meta))
        elif self.path == "/stats":
            self._json(200, self.engine.stats())
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/generate":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            emb = np.asarray(req["text_embedding"], dtype=np.float32)
            fut = self.engine.submit(
                emb, int(req["out_length"]),
                cfg_scale=req.get("cfg_scale"),
                seed=req.get("seed"))
            r = fut.result(timeout=600.0)
        except EngineOverloaded as e:
            self._json(503, {"error": str(e)})
            return
        except (KeyError, ValueError, TypeError,
                json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - surface engine errors
            self._json(500, {"error": str(e)})
            return
        self._json(200, dict(
            series=np.asarray(r.series).tolist(), seed=r.seed,
            out_length=r.out_length, cfg_scale=r.cfg_scale,
            latency_s=r.latency_s, batch_size=r.batch_size,
            batched_with=r.batched_with))


def make_server(engine: ServingEngine, host: str, port: int,
                meta: dict = None) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) and return the server; the caller runs
    ``serve_forever`` (or a thread, as the tests do)."""
    handler = type("Handler", (_Handler,),
                   dict(engine=engine, meta=meta or {}))
    return ThreadingHTTPServer((host, port), handler)


def build_server(argv=None, device=None):
    """Everything ``main`` does before ``serve_forever``: parse ``argv``,
    load the bundle on ``device`` (None = CUDA), build the engine, warm it
    up (``--warmup``; a kernel that fails to build or launch fails here)
    and bind. Returns (server, engine); the caller closes the server, then
    the engine."""
    args = get_args(argv)
    dev = init_from_env(resolve_device(device))
    vae, denoiser, buckets = load_bundle(args, dev)
    tiers = [int(t) for t in str(args.tiers).split(",")]
    plan = setup_scaling(args, batch_size=max(tiers), for_training=False)
    engine = ServingEngine(
        denoiser, vae, backbone=args.backbone, total_step=args.total_step,
        solver=args.solver, sample_steps=args.sample_steps or None,
        out_lengths=buckets, batch_tiers=tiers,
        max_wait_ms=args.max_wait_ms, default_cfg_scale=args.cfg_scale,
        text_emb_dim=args.text_emb_dim, scaling_plan=plan,
        max_pending=args.max_pending or None, device=dev)
    if args.warmup:
        n = len(buckets) * len(tiers)
        print(f"Warming up {n} programs...", flush=True)
        t0 = time.perf_counter()
        engine.warmup()
        print(f"Warmed up {n} programs in {time.perf_counter() - t0:.3f} s",
              flush=True)
    server = make_server(engine, args.host, args.port,
                         meta=dict(buckets=buckets, tiers=tiers,
                                   solver=args.solver,
                                   total_step=args.total_step))
    print(f"Serving on http://{args.host}:{server.server_address[1]} "
          f"(buckets={buckets}, tiers={tiers}, "
          f"max_wait={args.max_wait_ms}ms)", flush=True)
    return server, engine


def run_worker(argv=None, device=None) -> int:
    """A data-parallel server's rank other than 0: load the same bundle
    and serve rank 0's dispatches (``serve_worker``) until its engine
    closes. Returns the number of dispatches served."""
    args = get_args(argv)
    dev = init_from_env(resolve_device(device))
    vae, denoiser, buckets = load_bundle(args, dev)
    tiers = [int(t) for t in str(args.tiers).split(",")]
    plan = setup_scaling(args, batch_size=max(tiers), for_training=False)
    return serve_worker(plan, denoiser, vae, backbone=args.backbone,
                        total_step=args.total_step, solver=args.solver,
                        sample_steps=args.sample_steps or None,
                        out_lengths=buckets, text_emb_dim=args.text_emb_dim,
                        device=dev)


def main(argv=None, device=None):
    """Serve until Ctrl-C on ``device`` (None = CUDA: raises on a machine
    with no card unless ``device="cpu"``)."""
    get_args(argv)                       # --help and bad flags exit here
    dev = init_from_env(resolve_device(device))
    if not is_main():
        run_worker(argv, dev)
        return
    server, engine = build_server(argv, dev)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
