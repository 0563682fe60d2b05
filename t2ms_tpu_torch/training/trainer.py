"""Denoiser and LA-VAE training steps (counterpart of
t2ms_tpu/training/trainer.py).

Reference loop (train.py:52-136): batch -> frozen VAE encode -> sample t
-> flow interpolant (or the DDPM forward noising, target eps) -> CFG text
drop (one Bernoulli(0.3) per optimizer step) -> denoiser forward -> MSE ->
AdamW step.

The JAX package builds one jitted, donated function over an immutable
TrainState; the port updates the denoiser's parameters and the
optimizer's state in place and returns the loss as a tensor, with no host
sync inside a step (``nan_guard`` reads one flag on the host). After a
step each parameter's ``.grad`` holds the step's averaged gradient.

On CUDA a DiT trains through ``dit_fast.fast_dit_train_forward`` (the
hand-written block forward and backward kernels) when they take its
geometry (inside the JAX token range 128..1024), else through
``dit_fast.flax_path_forward`` (the LayerNorm + modulate and gated residual
+ LayerNorm + modulate kernels, forward and backward, and the attention as
JAX picks it on a TPU: the fused-heads kernels with their single-pass or
two-pass backward, or the flash kernel with its einsum-recompute backward),
else the step raises; only an explicit ``attention_impl`` opts out to the
eager module, which is also the path on the CPU.

torch cannot reproduce the JAX package's threefry draws, so every random
draw can be passed in: ``u`` (the uniform behind t, per row), ``x_0`` (the
flow's noise, or DDPM's eps, per row) and ``coin`` (the CFG drop draw, one
per optimizer step). Otherwise they come from ``generator``, once a step
and for the whole batch, in the order coin, u, x_0, and each microbatch
takes its rows of them. The DDPM timestep is t = floor(u * T) as int32,
as in JAX.

Data parallelism (a ``mesh`` whose process group spans W data ranks, one
process per device): each rank passes its own rows of the global batch.
The step draws ``coin``, ``u`` and ``x_0`` for the whole global batch
from the same generator state on every rank (JAX draws over the global
batch and lets XLA shard), and each rank uses its own rows; injected
``u``/``x_0`` likewise cover the global batch. Gradients are all-reduced
(the mean over ``data``) before the optimizer step, the loss returned is
the global mean, and ``nan_guard``'s flag is all-reduced so every rank
skips together. So every row gets the draws it gets on one device, and a
W-rank step is the one-rank step on the concatenated batch at any
``accum_steps`` (up to the order of the gradient sums). Inside each rank
the forward is what it is without a mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.models.backbones import ddpm as ddpm_lib
from t2ms_tpu_torch.models.backbones import rectified_flow as rf

__all__ = ["encode_with_vae", "make_denoiser_train_step",
           "make_vae_train_step", "precompute_latent_buckets",
           "DenoiserTrainStep", "VAETrainStep"]


def encode_with_vae(vae_model, x):
    """Frozen VAE encode (no graph): (z, before)."""
    with torch.no_grad():
        return vae_model.encode(x)


def _training_forward(denoiser):
    """The forward of each call, in the JAX package's order
    (t2ms_tpu/training/trainer.py ``_training_forward``): for a DiT on
    CUDA, the block kernels when they take its geometry, else the flax
    path's kernels, else raise (the eager model is not run in their
    place); the eager module on the CPU or under an explicit
    ``attention_impl`` opt-out. Each check asks a kernel library."""
    from t2ms_tpu_torch.models.denoisers import dit_fast

    def forward(x, t, e, m):
        if not dit_fast.fused_path_eligible(denoiser, x.device):
            return denoiser(x, t, e, m)
        if dit_fast.train_forward_supported(denoiser):
            return dit_fast.fast_dit_train_forward(denoiser, x, t, e, m)
        if dit_fast.flax_path_supported(denoiser):
            return dit_fast.flax_path_forward(denoiser, x, t, e, m)
        d = denoiser
        raise ValueError(
            f"the port does not train this DiT on CUDA: neither the block "
            f"kernels (fused_dit_block, _fused_block_diff_bwd; 128 <= tokens "
            f"<= 1024) nor the flax path's "
            f"({dit_fast.flax_path_kernels(d, train=True)}) take "
            f"d_model={d.d_model} "
            f"heads={d.num_heads} hidden={int(d.d_model * d.mlp_ratio)} "
            f"tokens={d.num_patches} dtype={d.compute_dtype}; the eager "
            f"model is not run in their place (set attention_impl to opt "
            f"out)")

    return forward


def _nan_check_env() -> bool:
    """T2MS_NAN_CHECK: '0', 'false', 'no', 'off' and '' are off."""
    return os.environ.get("T2MS_NAN_CHECK", "").strip().lower() not in (
        "", "0", "false", "no", "off")


class DenoiserTrainStep:
    """``step(x, text_emb, u=None, x_0=None, coin=None, generator=None)``
    -> loss (0-d tensor). ``u`` (B,) and ``x_0`` (B, C, L) cover the whole
    batch and are split into microbatches as x is. ``steps`` counts
    attempted steps, skipped ones included."""

    def __init__(self, denoiser, vae_model, optimizer, backbone, total_step,
                 cfg_drop_prob, nan_guard, accum_steps, precoded, device,
                 mesh=None):
        self.denoiser, self.vae_model = denoiser, vae_model
        self.optimizer = optimizer
        self.sched = (ddpm_lib.make_schedule(total_step, device)
                      if backbone == "ddpm" else None)
        self.total_step, self.cfg_drop_prob = total_step, cfg_drop_prob
        self.nan_guard, self.accum_steps = nan_guard, accum_steps
        self.precoded, self.device = precoded, device
        self.forward = _training_forward(denoiser)
        self.mesh = (mesh if mesh is not None and getattr(
            mesh, "distributed", False) else None)
        self.steps = 0

    def _encode(self, x):
        if self.precoded:
            return x.detach()
        return encode_with_vae(self.vae_model, x)[0]

    def _loss(self, z, text_emb, keep, u, x_0):
        if self.sched is None:
            t = rf.sample_t(z.shape[0], self.total_step, u=u)
            x_t, x_0 = rf.create_flow(z, t, x_0=x_0)
            target = z - x_0
        else:
            t = torch.floor(u.float() * self.total_step).to(torch.int32)
            x_t, target = ddpm_lib.q_sample(self.sched, z, t, x_0)
        mask = keep.to(x_t.dtype).expand(z.shape[0])
        pred = self.forward(x_t, t, text_emb, mask)
        return torch.mean(torch.square(pred - target))

    def __call__(self, x, text_emb, u: Optional[torch.Tensor] = None,
                 x_0: Optional[torch.Tensor] = None,
                 coin: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dev = self.device
        x = torch.as_tensor(x, device=dev)
        text_emb = torch.as_tensor(text_emb, device=dev)
        B, k = x.shape[0], self.accum_steps
        if B % k:
            raise ValueError(f"batch {B} % accum_steps {k}")
        mb = B // k
        if coin is None:
            coin = torch.rand((), generator=generator, device=dev)
        # one Bernoulli per OPTIMIZER step: every microbatch shares it
        # (train.py:80-82), so a whole update is conditioned or dropped
        keep = torch.as_tensor(coin, device=dev) >= self.cfg_drop_prob
        W, off = 1, 0
        if self.mesh is not None:
            W = self.mesh.shape["data"]
            off = self.mesh.index("data") * B
        if u is None:
            u = torch.rand((B * W,), generator=generator, device=dev)
        cut = lambda a, i: torch.as_tensor(a, device=dev)[
            off + i * mb:off + (i + 1) * mb]
        params = [p for p in self.denoiser.parameters() if p.requires_grad]
        self.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=dev)
        for i in range(k):
            z = self._encode(x[i * mb:(i + 1) * mb])
            if x_0 is None:
                # the global batch's noise, drawn once the latent's shape
                # is known
                x_0 = torch.randn((B * W,) + tuple(z.shape[1:]),
                                  generator=generator, dtype=z.dtype,
                                  device=dev)
            loss = self._loss(z, text_emb[i * mb:(i + 1) * mb], keep,
                              cut(u, i), cut(x_0, i))
            (loss / k).backward()
            total = total + loss.detach()
        loss = total / k
        if self.mesh is not None:
            loss = self._all_reduce_mean(loss, params)
        if self.nan_guard:
            saved_p = [p.detach().clone() for p in params]
            saved_s = {p: {n: v.clone() if torch.is_tensor(v) else v
                           for n, v in self.optimizer.state[p].items()}
                       for p in params if p in self.optimizer.state}
        self.optimizer.step()
        if self.nan_guard:
            # skip the WHOLE update on a non-finite loss or update: params
            # and optimizer state (moments and count) keep their values;
            # new params are finite exactly when the update is
            ok = torch.isfinite(loss)
            for p in params:
                ok = ok & torch.isfinite(p).all()
            if self.mesh is not None:
                # every rank (data and model) skips together
                flag = ok.to(torch.int32).reshape(1)
                torch.distributed.all_reduce(
                    flag, op=torch.distributed.ReduceOp.MIN)
                ok = flag[0] > 0
            if not bool(ok):
                with torch.no_grad():
                    for p, old in zip(params, saved_p):
                        p.copy_(old)
                for p in params:
                    if p in saved_s:
                        self.optimizer.state[p] = saved_s[p]
                    else:
                        self.optimizer.state.pop(p, None)
        self.steps += 1
        return loss

    def _all_reduce_mean(self, loss, params):
        """Average every gradient (one flat all-reduce) and the loss over
        the ``data`` axis."""
        group, W = self.mesh.group("data"), self.mesh.shape["data"]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.reshape(1).to(params[0].grad.dtype)])
        torch.distributed.all_reduce(flat, group=group)
        flat /= W
        i = 0
        for p in params:
            p.grad.copy_(flat[i:i + p.numel()].view_as(p))
            i += p.numel()
        return flat[i].to(loss.dtype)


def make_denoiser_train_step(denoiser, vae_model, optimizer,
                             backbone: str = "flowmatching",
                             total_step: int = 100,
                             cfg_drop_prob: float = 0.3,
                             nan_guard: bool = False, accum_steps: int = 1,
                             precoded: bool = False,
                             device=None, mesh=None) -> DenoiserTrainStep:
    """Build the denoiser train step. ``device=None`` means CUDA (raises
    without it); the models must already live there. ``precoded`` means x
    is already the frozen-VAE latent. ``nan_guard`` (or T2MS_NAN_CHECK=1)
    skips the update when the loss or the update is non-finite. ``mesh``
    (a ``parallel.mesh.Mesh`` over a process group) makes the step data
    parallel over its ``data`` axis; a mesh without a group changes
    nothing."""
    dev = resolve_device(device)
    if backbone not in ("flowmatching", "ddpm"):
        raise ValueError(f"Unsupported backbone type: {backbone}")
    for name, m in (("denoiser", denoiser), ("vae_model", vae_model)):
        for p in m.parameters():
            if p.device.type != dev.type:
                raise ValueError(f"{name} lives on {p.device}, the step on "
                                 f"{dev}")
            break
    return DenoiserTrainStep(denoiser, vae_model, optimizer, backbone,
                             total_step, cfg_drop_prob,
                             nan_guard or _nan_check_env(), accum_steps,
                             precoded, dev, mesh)


@torch.no_grad()
def precompute_latent_buckets(vae_model, batcher, chunk: int = 4096,
                              max_bytes: int = 4 * 2 ** 30):
    """One frozen-VAE encode of every bucket's series: a new BucketBatcher
    whose ``x`` columns are the (N, C, latent_len) f32 latents, for a
    ``precoded=True`` train step (t2ms_tpu/training/trainer.py
    ``precompute_latent_buckets``). The encoder is frozen, deterministic
    and per-sample, so encoding once is the reference's per-step encode
    (train.py:73) without its cost. Chunks of ``chunk`` rows run on the
    VAE's device; no padding, as torch compiles nothing per shape. Returns
    None (the caller keeps the in-step encode) when the latent store would
    exceed ``max_bytes`` of host memory."""
    import numpy as np

    from t2ms_tpu_torch.data.loaders import BucketBatcher

    dev = next(vae_model.parameters()).device
    enc = lambda a: vae_model.encode(torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(dev))[0]
    probe = next(iter(batcher.buckets.values()))["x"]
    per_row = int(np.prod(enc(probe[:1]).shape[1:])) * 4
    total = sum(d["x"].shape[0] for d in batcher.buckets.values()) * per_row
    if total > max_bytes:
        return None
    new_buckets = {}
    for length, data in batcher.buckets.items():
        x = np.asarray(data["x"])
        zs = [enc(x[s:s + chunk]).cpu().numpy()
              for s in range(0, x.shape[0], chunk)]
        new_buckets[length] = dict(data, x=np.concatenate(zs))
    return BucketBatcher(new_buckets, batcher.batch_size, batcher.seed,
                         batcher.drop_last, batcher.process_index,
                         batcher.process_count)


class VAETrainStep:
    """``step(x)`` -> (loss, recon_error), 0-d tensors; one LA-VAE update
    on ``lavae_loss`` (vqvae.py:118-127). ``steps`` counts steps."""

    def __init__(self, vae_model, optimizer, device):
        self.vae_model, self.optimizer, self.device = (vae_model, optimizer,
                                                       device)
        self.steps = 0

    def __call__(self, x):
        from t2ms_tpu_torch.models.vae.lavae import lavae_loss
        self.optimizer.zero_grad(set_to_none=True)
        loss, (recon_err, _, _) = lavae_loss(
            self.vae_model, torch.as_tensor(x, device=self.device))
        loss.backward()
        self.optimizer.step()
        self.steps += 1
        return loss.detach(), recon_err.detach()


def make_vae_train_step(vae_model, optimizer, device=None) -> VAETrainStep:
    """Build the LA-VAE pretraining step; ``device=None`` means CUDA."""
    return VAETrainStep(vae_model, optimizer, resolve_device(device))
