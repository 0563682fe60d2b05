"""Weight bridge from the JAX package: a flax param tree (nested dicts of
numpy arrays, as ``jax.device_get(params)`` gives) -> the port's
``state_dict``.

Rules: Dense kernels transpose (in, out) -> (out, in); the patchify
``patch_conv`` (4 -> 4 linear on (ph, pw)-ordered pixels) folds back into
the reference Conv2d(1, 4, k=2, s=2) layout; Conv1d (O, C, K) and
ConvTranspose1d (C, O, K) weights copy as they are; LayerNorm scale/bias
become weight/bias. The inverse direction is
``tools/import_torch_ckpt.py`` (reference state_dict -> flax tree).

The rules only rearrange elements (transposes and reshapes), so
``dit_params_from_jax`` maps any tree shaped like the params the same way:
a gradient tree, or optax's Adam moments. ``adamw_state_from_optax`` uses
that to carry an ``optax.adamw`` state into a torch AdamW, so a port run
resumes a JAX run.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["dit_params_from_jax", "mlp_params_from_jax",
           "lavae_params_from_jax", "ts2vec_params_from_jax",
           "adamw_state_from_optax"]


def _inner(tree) -> dict:
    return tree["params"] if "params" in tree else tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T)
    sd[f"{key}.bias"] = _t(node["bias"])


def dit_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax DiT params -> ``t2ms_tpu_torch...dit.DiT`` state_dict."""
    p = _inner(tree)
    sd: Dict[str, torch.Tensor] = {}
    pk = np.asarray(p["patch_conv"]["kernel"])          # (in=p*p, out)
    ps = int(round(pk.shape[0] ** 0.5))
    sd["conv.weight"] = _t(pk.T.reshape(pk.shape[1], 1, ps, ps))
    sd["conv.bias"] = _t(p["patch_conv"]["bias"])
    _dense(sd, "patch_emb", p["patch_emb"])
    depth = sum(1 for k in p if k.startswith("block_"))
    for i in range(depth):
        b, r = p[f"block_{i}"], f"layers.{i}"
        _dense(sd, f"{r}.attn.qkv", b["attn"]["qkv"])
        _dense(sd, f"{r}.attn.proj", b["attn"]["proj"])
        _dense(sd, f"{r}.mlp.fc1", b["mlp"]["fc1"])
        _dense(sd, f"{r}.mlp.fc2", b["mlp"]["fc2"])
        _dense(sd, f"{r}.adaLN_modulation.1", b["adaLN_modulation"])
    sd["ln.weight"] = _t(p["final_ln"]["scale"])
    sd["ln.bias"] = _t(p["final_ln"]["bias"])
    _dense(sd, "linear_emb_to_patch", p["unpatch"])
    return sd


def mlp_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax MLPDenoiser params -> ``t2ms_tpu_torch...mlp.MLPDenoiser``
    state_dict (flax ``layer_{i}`` -> the reference's ``layers.{i}``)."""
    p = _inner(tree)
    sd: Dict[str, torch.Tensor] = {}
    depth = sum(1 for k in p if k.startswith("layer_"))
    for i in range(depth):
        lp, r = p[f"layer_{i}"], f"layers.{i}"
        for n in ("key", "query", "value", "proj"):
            _dense(sd, f"{r}.cross_attn.{n}", lp["cross_attn"][n])
        sd[f"{r}.norm2.weight"] = _t(lp["norm"]["scale"])
        sd[f"{r}.norm2.bias"] = _t(lp["norm"]["bias"])
        _dense(sd, f"{r}.mlp.0", lp["mlp_fc1"])
        _dense(sd, f"{r}.mlp.2", lp["mlp_fc2"])
        _dense(sd, f"{r}.mlp2.0", lp["mlp2_fc1"])
        _dense(sd, f"{r}.mlp2.2", lp["mlp2_fc2"])
    return sd


def _conv(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _t(node["kernel"])
    if "bias" in node:
        sd[f"{key}.bias"] = _t(node["bias"])


def _res_stack(sd: dict, root: str, node: dict) -> None:
    n = sum(1 for k in node if k.endswith("_conv3"))
    for i in range(n):
        blk = f"{root}._residual_stack._layers.{i}._block"
        _conv(sd, f"{blk}.1", node[f"res{i}_conv3"])
        _conv(sd, f"{blk}.3", node[f"res{i}_conv1"])


def lavae_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax LAVAE params -> ``t2ms_tpu_torch...lavae.LAVAE`` state_dict."""
    p = _inner(tree)
    sd: Dict[str, torch.Tensor] = {}
    if "encoder" in p:
        enc = p["encoder"]
        for j in (1, 2, 3):
            _conv(sd, f"encoder._conv_{j}", enc[f"conv{j}"])
        _res_stack(sd, "encoder", enc["res_stack"])
        _conv(sd, "encoder._pre_vq_conv", enc["pre_vq"])
    if "decoder" in p:
        dec = p["decoder"]
        _conv(sd, "decoder._conv_1", dec["conv1"])
        _res_stack(sd, "decoder", dec["res_stack"])
        _conv(sd, "decoder._conv_trans_1", dec["convt1"])
        _conv(sd, "decoder._conv_trans_2", dec["convt2"])
    return sd


def ts2vec_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax TSEncoder params -> ``t2ms_tpu_torch...ts2vec.TSEncoder``
    state_dict: ``input_fc`` and each ``block_{i}``'s ``projector`` are
    Dense (transposed), its ``conv1``/``conv2`` kernels (O, I, 3) copy."""
    p = _inner(tree)
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "input_fc", p["input_fc"])
    depth = sum(1 for k in p if k.startswith("block_"))
    for i in range(depth):
        b, r = p[f"block_{i}"], f"blocks.{i}"
        _conv(sd, f"{r}.conv1", b["conv1"])
        _conv(sd, f"{r}.conv2", b["conv2"])
        if "projector" in b:
            _dense(sd, f"{r}.projector", b["projector"])
    return sd


def adamw_state_from_optax(optimizer: torch.optim.Optimizer,
                           model: torch.nn.Module, opt_state,
                           params_from_jax=dit_params_from_jax) -> None:
    """Load an ``optax.adamw`` state (numpy leaves, as ``jax.device_get``
    gives) into ``optimizer``, a torch AdamW over ``model``'s parameters:
    optax's ``ScaleByAdamState`` (count, mu, nu) becomes each parameter's
    ``step``, ``exp_avg`` and ``exp_avg_sq``, mapped by the same rules as
    the params (``params_from_jax``). The Adam state is found by its
    fields, so the chain's other states are skipped."""
    stack = [opt_state]
    adam = None
    while stack and adam is None:
        node = stack.pop()
        if all(hasattr(node, f) for f in ("count", "mu", "nu")):
            adam = node
        elif isinstance(node, (tuple, list)):
            stack.extend(reversed(node))
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) found")
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    step = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype).reshape(p.shape),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).reshape(p.shape)}
