"""The port's HTTP serving front-end (``cli.serve``) and the engine's
``warmup()`` and scaling plans on the CPU (``device="cpu"``): the JAX
serve tests' contract (tests/test_serve_http.py) on an in-process
ThreadingHTTPServer on an ephemeral loopback port: healthz and stats, a
round trip that is deterministic and equals the serving sampler called
directly, concurrent clients batched, 400 for each bad request, 404, 503
on overload; ``get_args`` against JAX's parser for the same argv;
``load_bundle`` from the random init with its WARNING; ``build_server``
and ``main`` (Ctrl-C closes the server and drains the engine);
``--denoiser MLP`` through ``build_server`` and one request. Every
network wait has a timeout of at most 30 s; samplers run at most 3 steps.

Tolerance: the HTTP series equals the direct sampler's within rtol 1e-5
/ atol 1e-6 (the same computation, serialized through JSON floats)."""

import json
import runpy
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from t2ms_tpu.cli.serve import get_args as j_get_args
from t2ms_tpu_torch.cli import serve as tserve
from t2ms_tpu_torch.cli.serve import get_args, load_bundle, make_server
from t2ms_tpu_torch.models.denoisers import DiT, MLPDenoiser
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.serving import ServingEngine, make_serving_sampler
from t2ms_tpu_torch.training.scaling import ScalingPlan, setup_scaling

EMB, T = 32, 24
WAIT = 30


def _models(seed=0):
    torch.manual_seed(seed)
    vae = LAVAE(1, 16, 2, 16, 8, 6, device="cpu").eval()
    dit = DiT(6, 8, EMB, 1, 2, device="cpu")
    with torch.no_grad():
        for p in dit.parameters():          # off adaLN-zero
            p.add_(0.05 * torch.randn(p.shape))
    return vae, dit


def _engine(vae, dit, **kw):
    kw.setdefault("total_step", 3)
    kw.setdefault("out_lengths", (T,))
    kw.setdefault("batch_tiers", (1, 2, 4))
    kw.setdefault("max_wait_ms", 10.0)
    kw.setdefault("text_emb_dim", EMB)
    kw.setdefault("device", "cpu")
    return ServingEngine(dit, vae, **kw)


def _serve(engine, meta=None):
    server = make_server(engine, "127.0.0.1", 0, meta=meta)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, engine):
    server.shutdown()
    server.server_close()
    engine.close()


@pytest.fixture(scope="module")
def http_ctx():
    vae, dit = _models()
    engine = _engine(vae, dit)
    server, url = _serve(engine, dict(buckets=[T], tiers=[1, 2, 4]))
    yield dict(url=url, vae=vae, dit=dit, engine=engine)
    _stop(server, engine)


def _post(url, payload, path="/generate"):
    data = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=WAIT) as r:
        return json.loads(r.read())


def test_healthz_and_stats(http_ctx):
    h = _get(http_ctx["url"], "/healthz")
    assert h["ok"] and h["buckets"] == [T] and h["tiers"] == [1, 2, 4]
    s = _get(http_ctx["url"], "/stats")
    assert set(s) >= {"requests", "batches", "padding_fraction",
                      "p50_latency_s", "p95_latency_s"}


def test_generate_roundtrip_determinism_and_direct_sampler(http_ctx):
    c = http_ctx
    emb = [0.1] * EMB
    r1 = _post(c["url"], dict(text_embedding=emb, out_length=T,
                              cfg_scale=3.0, seed=7))
    assert r1["seed"] == 7 and r1["out_length"] == T
    assert r1["cfg_scale"] == 3.0 and r1["batch_size"] in (1, 2, 4)
    assert r1["batched_with"] >= 1 and r1["latency_s"] > 0
    series = np.asarray(r1["series"], dtype=np.float32)
    assert series.shape == (T,) and np.isfinite(series).all()
    r2 = _post(c["url"], dict(text_embedding=emb, out_length=T,
                              cfg_scale=3.0, seed=7))
    np.testing.assert_allclose(np.asarray(r2["series"]), series,
                               rtol=1e-5, atol=1e-6)
    direct = make_serving_sampler(c["dit"], c["vae"], "flowmatching", 3,
                                  c["engine"]._latent[T], T, device="cpu")
    want = direct(np.array([7], np.uint32), np.array([3.0], np.float32),
                  np.array([emb], np.float32)).numpy()[0]
    np.testing.assert_allclose(series, want, rtol=1e-5, atol=1e-6)


def test_concurrent_clients_get_batched(http_ctx):
    outs = {}

    def client(i):
        outs[i] = _post(http_ctx["url"], dict(
            text_embedding=list(np.linspace(0, 1, EMB) * (i + 1)),
            out_length=T, seed=50 + i))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert sorted(outs) == [0, 1, 2, 3]
    assert all(np.isfinite(np.asarray(o["series"])).all()
               for o in outs.values())
    assert [outs[i]["seed"] for i in range(4)] == [50, 51, 52, 53]
    assert not np.allclose(outs[0]["series"], outs[3]["series"])


@pytest.mark.parametrize("payload", [
    dict(text_embedding=[0.0] * EMB, out_length=999),
    dict(text_embedding=[0.0] * 5, out_length=T),
    dict(out_length=T),
    dict(text_embedding=[0.0] * EMB),
    b"{not json",
], ids=["unadmitted-length", "embedding-width", "no-embedding",
        "no-length", "bad-json"])
def test_bad_requests_are_400(http_ctx, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http_ctx["url"], payload)
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())


def test_unknown_paths_are_404(http_ctx):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(http_ctx["url"], "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http_ctx["url"], dict(out_length=T), path="/nope")
    assert e.value.code == 404


def test_overload_returns_503():
    """Admission control surfaces as HTTP 503 (engine queue full)."""
    vae, dit = _models(1)
    # tier 4 can never fill and the deadline is far: submits stay queued
    engine = _engine(vae, dit, total_step=2, batch_tiers=(4,),
                     max_wait_ms=60_000.0, max_pending=1)
    server, url = _serve(engine)
    payload = dict(text_embedding=[0.0] * EMB, out_length=T)
    first = threading.Thread(target=lambda: _post(url, payload), daemon=True)
    try:
        first.start()
        deadline = time.monotonic() + WAIT
        while engine.stats()["requests"] < 1:
            assert time.monotonic() < deadline, "first request never queued"
            time.sleep(0.01)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, payload)
        assert e.value.code == 503
    finally:
        _stop(server, engine)          # drains the parked request
        first.join(timeout=WAIT)
    assert not first.is_alive()
    assert engine.stats()["served_rows"] == 1


@pytest.mark.parametrize("argv", [
    [],
    ["--buckets", "24,96", "--tiers", "1,8", "--port", "0",
     "--total_step", "5", "--denoiser", "MLP", "--compute_dtype", "f32"],
    ["--dataset_name", "ETTh1_24", "--checkpoint_id", "1", "--backbone",
     "ddpm", "--solver", "ddim", "--sample_steps", "25", "--warmup", "0",
     "--max_pending", "0", "--vae_file", "v.pth", "--checkpoint_file",
     "m.pth", "--latent_grid", "6"],
])
def test_get_args_match_jax(argv):
    """The same flags, defaults and derived paths as JAX's server."""
    assert vars(get_args(argv)) == vars(j_get_args(argv))


def test_load_bundle_random_init(tmp_path, capsys):
    """Without checkpoints on disk, load_bundle builds the T2S-scale
    bundle from the deterministic random init (WARNING lines, not a crash)
    on the given device and parses the bucket list."""
    a = get_args(["--buckets", "24,48", "--save_path", str(tmp_path),
                  "--dataset_name", f"{tmp_path.name}_24"])
    vae, dit, buckets = load_bundle(a, device="cpu")
    assert buckets == [24, 48]
    assert isinstance(dit, DiT) and dit.compute_dtype == torch.bfloat16
    with torch.no_grad():
        z, _ = vae.encode(torch.zeros(1, 48))
        assert tuple(z.shape) == (1, 64, 30)
        assert dit(z, torch.zeros(1), torch.zeros(1, 128)).shape == z.shape
    out = capsys.readouterr().out
    assert "WARNING: no pretrained VAE" in out
    assert "WARNING: no checkpoint" in out


class _Counting:
    def __init__(self, fn, calls, L):
        self.fn, self.calls, self.L = fn, calls, L

    def __call__(self, seeds, cfg, emb, **kw):
        self.calls.append((self.L, len(seeds), float(np.abs(emb).max()),
                           tuple(np.unique(cfg))))
        return self.fn(seeds, cfg, emb, **kw)


def test_warmup_runs_every_bucket_and_tier_once():
    """One call per (bucket, tier) with zero embeddings and the default
    cfg; stats() and the seed counter are untouched, so the first request
    still draws seed 0."""
    vae, dit = _models(2)
    calls = []
    with _engine(vae, dit, out_lengths=(16, T), batch_tiers=(1, 2),
                 default_cfg_scale=4.0, max_wait_ms=5.0) as eng:
        for L in list(eng._samplers):
            eng._samplers[L] = _Counting(eng._samplers[L], calls, L)
        before = eng.stats()
        eng.warmup()
        assert sorted(calls) == [(16, 1, 0.0, (4.0,)), (16, 2, 0.0, (4.0,)),
                                 (T, 1, 0.0, (4.0,)), (T, 2, 0.0, (4.0,))]
        assert eng.stats() == before and eng._seed_counter == 0
        r = eng.submit(np.zeros(EMB, np.float32), T).result(timeout=WAIT)
    assert r.seed == 0 and eng.stats()["requests"] == 1


@pytest.mark.parametrize("n_data", [1, 2])
def test_one_device_plan_is_taken_and_data_parallel_refused(n_data):
    vae, dit = _models(3)
    plan = ScalingPlan(n_data, 1, torch.float32)
    if n_data > 1:
        # a data-parallel plan without its ranks' process group never
        # runs undistributed
        with pytest.raises(ValueError,
                           match="n_data=2 and no process group"):
            _engine(vae, dit, scaling_plan=plan)
        return
    with _engine(vae, dit, scaling_plan=plan) as eng:
        r = eng.submit(np.zeros(EMB, np.float32), T).result(timeout=WAIT)
    assert np.isfinite(r.series).all()
    # cli.serve's own plan is a one-device plan
    served = setup_scaling(get_args(["--tiers", "1,64"]), batch_size=64,
                           for_training=False)
    assert served.n_data == 1 and served.compute_dtype == torch.bfloat16


def _serve_argv(tmp_path, *extra):
    return ["--port", "0", "--save_path", str(tmp_path), "--dataset_name",
            f"{tmp_path.name}_24", "--buckets", "24", "--tiers", "1",
            "--total_step", "2", "--max_wait_ms", "1", *extra]


@pytest.mark.parametrize("denoiser,cls", [("MLP", MLPDenoiser),
                                          ("DiT", DiT)])
def test_build_server_warms_up_and_answers(tmp_path, capsys, monkeypatch,
                                           denoiser, cls):
    """``--denoiser MLP`` (and the DiT) through cli.serve's own
    build_server: load_bundle, the engine, warmup, bind; then one HTTP
    request."""
    bundles = []
    monkeypatch.setattr(tserve, "load_bundle", lambda a, d: bundles.append(
        load_bundle(a, d)) or bundles[-1])
    server, engine = tserve.build_server(
        _serve_argv(tmp_path, "--denoiser", denoiser, "--compute_dtype",
                    "f32"), device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        r = _post(url, dict(text_embedding=[0.5] * 128, out_length=24,
                            seed=3))
        assert engine.stats()["requests"] == 1
    finally:
        _stop(server, engine)
    assert isinstance(bundles[0][1], cls)
    assert np.asarray(r["series"]).shape == (24,) and r["seed"] == 3
    assert np.isfinite(r["series"]).all()
    out = capsys.readouterr().out
    assert "Warmed up 1 programs in" in out
    assert f"Serving on http://127.0.0.1:{server.server_address[1]}" in out


def test_main_serves_until_ctrl_c(tmp_path, monkeypatch, capsys):
    """main adds only serve_forever: Ctrl-C closes the server, drains the
    engine and returns (exit 0)."""
    seen = {}

    def interrupted(self, *a, **kw):
        seen["port"] = self.server_address[1]
        raise KeyboardInterrupt

    monkeypatch.setattr(tserve.ThreadingHTTPServer, "serve_forever",
                        interrupted)
    closed = []
    real_close = ServingEngine.close
    monkeypatch.setattr(ServingEngine, "close",
                        lambda self, drain=True: closed.append(drain)
                        or real_close(self, drain))
    assert tserve.main(_serve_argv(tmp_path, "--warmup", "0"),
                       device="cpu") is None
    assert closed == [True]
    assert f"Serving on http://127.0.0.1:{seen['port']}" in \
        capsys.readouterr().out


def test_main_refuses_a_machine_with_no_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(_serve_argv(tmp_path))


def test_serve_runs_as_a_module(monkeypatch, capsys):
    """``python -m t2ms_tpu_torch.cli.serve`` in this process (runpy)."""
    monkeypatch.setattr(sys, "argv", ["serve", "--help"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("t2ms_tpu_torch.cli.serve", run_name="__main__")
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--warmup", "--max_pending", "--compute_dtype", "--tiers"):
        assert flag in out
