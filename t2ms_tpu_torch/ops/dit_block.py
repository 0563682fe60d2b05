"""The adaLN-zero blocks of the DiT and the flax path's block boundaries
(counterpart of t2ms_tpu/ops/dit_block.py ``fused_dit_stack``,
``fused_dit_block``, ``fused_dit_block_diffable``,
``fused_dit_block_split``, ``mod_ln_diffable`` and
``res_mod_ln_diffable``).

All keep the JAX signatures and layouts: x (B, N, D), per-sample adaLN
vectors mod (B, L, 6, D) for the stack and (B, 6, D) for one block, flax
Dense-layout weights (kernel (in, out), bias (out,)), stacked over the
layer axis for the stack, and weights/biases cast to x's dtype as the JAX
wrappers' ``w(a)`` does.

* On a CUDA tensor they launch the hand-written kernels: the forward of
  ``csrc/dit_stack.cu`` (three per layer; in bf16 at head widths 16, 32,
  64 and 128 those of ``csrc/dit_layer.cuh``: modLN+qkv, the register-tile
  attention, proj+gated residual+modLN+MLP+gated residual; otherwise
  modLN+qkv, attention+proj+gated residual, modLN+MLP+gated residual; one
  block is the stack with L = 1),
  the block backward of ``csrc/dit_block_bwd.cu``, and the wide-geometry
  block of ``csrc/dit_split.cu`` (modLN+qkv, attention, proj+gated
  residual, modLN+fc1+GELU, fc2+gated residual), and the LayerNorm +
  modulate forward and backward of ``csrc/mod_ln.cu``, with and without
  the gated residual fused in front. Each wrapper counts
  its launches under its own name. A shape the kernels do not take (the
  libraries' own limits), a failed build or a failed launch raises; there
  is no fallback.
* On a CPU tensor they run the plain PyTorch twins, which follow
  ``_block_math`` step by step; the twin of a backward is autograd over
  the twin of its forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from t2ms_tpu_torch.ops import _build
from t2ms_tpu_torch.ops.attention import fused_heads_reference

__all__ = ["fused_dit_stack", "fused_dit_stack_reference",
           "dit_stack_reference_block", "stack_kernel_supported",
           "fused_dit_block", "fused_dit_block_reference",
           "fused_dit_block_diffable", "block_kernel_supported",
           "block_attn_stats", "block_attn_bwd_reference",
           "mlp_half_bwd_reference", "qkv_half_bwd_reference",
           "fused_dit_block_split", "split_kernel_supported",
           "split_gemm_reference", "split_gemm_route", "SPLIT_GEMM_STAGES",
           "SPLIT_GEMM_KERNEL",
           "mod_ln_diffable", "mod_ln_reference", "mod_ln_supported",
           "res_mod_ln_diffable", "res_mod_ln_reference",
           "res_mod_ln_supported", "STACK_KERNEL", "BLOCK_KERNEL",
           "BLOCK_BWD_KERNEL", "SPLIT_KERNEL", "MOD_LN_KERNEL",
           "MOD_LN_BWD_KERNEL", "RES_MOD_LN_KERNEL", "RES_MOD_LN_BWD_KERNEL"]

STACK_KERNEL = "fused_dit_stack"
BLOCK_KERNEL = "fused_dit_block"
BLOCK_BWD_KERNEL = "_fused_block_diff_bwd"
SPLIT_KERNEL = "fused_dit_block_split"
SPLIT_GEMM_KERNEL = "split_gemm"
MOD_LN_KERNEL = "_mod_ln_call"
MOD_LN_BWD_KERNEL = "_mod_ln_diff_bwd"
RES_MOD_LN_KERNEL = "_res_mod_ln_call"
RES_MOD_LN_BWD_KERNEL = "_res_mod_ln_diff_bwd"
# the block backward's MLP-half and qkv-half kernels launched alone
MLP_HALF_BWD_KERNEL = "mlp_half_bwd"
QKV_HALF_BWD_KERNEL = "qkv_half_bwd"
_ENTRY = {torch.bfloat16: "dit_stack_forward_bf16",
          torch.float32: "dit_stack_forward_f32"}
_BWD_ENTRY = {torch.bfloat16: "dit_block_backward_bf16",
              torch.float32: "dit_block_backward_f32"}
_SPLIT_ENTRY = {torch.bfloat16: "dit_split_forward_bf16",
                torch.float32: "dit_split_forward_f32"}
_MOD_LN_ENTRY = {torch.bfloat16: "mod_ln_forward_bf16",
                 torch.float32: "mod_ln_forward_f32"}
_MOD_LN_BWD_ENTRY = {torch.bfloat16: "mod_ln_backward_bf16",
                     torch.float32: "mod_ln_backward_f32"}
_RES_ENTRY = {torch.bfloat16: "res_mod_ln_forward_bf16",
              torch.float32: "res_mod_ln_forward_f32"}
_RES_BWD_ENTRY = {torch.bfloat16: "res_mod_ln_backward_bf16",
                  torch.float32: "res_mod_ln_backward_f32"}


# --------------------------------------------------------------- plain twin

def _ln(x, eps):
    """LayerNorm without scale/bias in f32 (DiT block LNs)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def _mod_ln(x, sh, sc, eps):
    """LN -> adaLN modulate at f32, back to the compute dtype."""
    return (_ln(x, eps) * (1.0 + sc.float()) + sh.float()).to(x.dtype)


def _dense(h, w, b):
    """Dense with f32 accumulation and f32 bias add, cast back to h's
    dtype (bf16 operands are exact in f32)."""
    return (torch.matmul(h.float(), w.float()) + b.float()).to(h.dtype)


def dit_stack_reference_block(x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1,
                              wfc2, bfc2, num_heads: int, eps: float = 1e-6):
    """One adaLN-zero block (``_block_math``) on batched tensors: x
    (B, N, D), mod (B, 6, D), weights already in x's dtype."""
    dt = x.dtype
    D = x.shape[-1]
    m = lambda i: mod[:, i][:, None, :]                       # (B, 1, D)
    qkv = _dense(_mod_ln(x, m(0), m(1), eps), wqkv, bqkv)
    attn = fused_heads_reference(qkv[..., :D], qkv[..., D:2 * D],
                                 qkv[..., 2 * D:], num_heads)
    x = x + m(2).to(dt) * _dense(attn, wproj, bproj)
    h1 = F.gelu(_dense(_mod_ln(x, m(3), m(4), eps), wfc1, bfc1),
                approximate="tanh")
    return x + m(5).to(dt) * _dense(h1, wfc2, bfc2)


def block_attn_stats(q, k, v, do, num_heads: int, scale: float):
    """What the block backward's attention VJP reads besides q, k, v and
    do, as its kernels make it: each (row, head)'s score max m and row sum
    r = sum f32(T(exp(T(s - m)))) (the recompute's forward), and
    delta = sum over the head of T(do) * o with o the attention output in
    q's dtype (the attention-output kernel). q, k, v, do (B, N, H*D);
    returns three f32 (B, N, H)."""
    dt = q.dtype
    D = q.shape[-1] // num_heads
    o = fused_heads_reference(q, k, v, num_heads, scale)
    ms, rs, deltas = [], [], []
    for h in range(num_heads):
        sl = slice(h * D, (h + 1) * D)
        qs = (q[..., sl] * torch.tensor(scale, dtype=dt)).float()
        s = torch.matmul(qs, k[..., sl].float().transpose(-1, -2))
        m = s.amax(dim=-1)
        ms.append(m)
        rs.append(torch.exp((s - m[..., None]).to(dt)).float().sum(dim=-1))
        deltas.append((do[..., sl].to(dt).float() * o[..., sl].float())
                      .sum(dim=-1))
    return tuple(torch.stack(t, dim=-1) for t in (ms, rs, deltas))


def block_attn_bwd_reference(q, k, v, do, m, r, delta, scale: float):
    """Plain twin of the block backward's attention VJP (the BLOCK recipe
    of ``csrc/heads_bwd.cuh``), written out with its rounding points: per
    head, qs = T(q * scale), s = qs k^T in f32, e = T(exp(T(s - m))),
    p = e * (1/r) (one reciprocal a row), dp = do v^T, ds = T(p (dp -
    delta)), dq = T((ds k) * scale), dk = T(ds^T qs), dv = T(T(p)^T do);
    T() rounds to q's dtype, every product sums in f32. q, k, v, do
    (B, N, H*D); m, r, delta (B, N, H) f32 (``block_attn_stats``); returns
    (dq, dk, dv) in q's dtype."""
    dt = q.dtype
    H = m.shape[-1]
    D = q.shape[-1] // H
    T = lambda t: t.to(dt).float()
    outs = ([], [], [])
    for h in range(H):
        sl = slice(h * D, (h + 1) * D)
        kh, vh = k[..., sl].float(), v[..., sl].float()
        g = do[..., sl].to(dt).float()
        qs = T(q[..., sl].float() * scale)
        s = torch.matmul(qs, kh.transpose(-1, -2))
        e = T(torch.exp(T(s - m[..., h, None])))
        p = e * (1.0 / r[..., h, None])
        dp = torch.matmul(g, vh.transpose(-1, -2))
        ds = T(p * (dp - delta[..., h, None]))
        outs[0].append(torch.matmul(ds, kh) * scale)
        outs[1].append(torch.matmul(ds.transpose(-1, -2), qs))
        outs[2].append(torch.matmul(T(p).transpose(-1, -2), g))
    return tuple(torch.cat(o, dim=-1).to(dt) for o in outs)


_GELU_K, _GELU_C = 0.7978845608028654, 0.044715     # sqrt(2/pi), tanh-GELU's


def _gelu_exp(v):
    """tanh-GELU in f32 as the bf16 row kernels take it: v / (1 + exp(-2u)),
    u = sqrt(2/pi) (v + 0.044715 v^3), since 0.5 (1 + tanh(u)) = 1 / (1 +
    exp(-2u)). The same function as ``F.gelu(approximate="tanh")``, its
    value differing in the last f32 bits."""
    u = _GELU_K * (v + _GELU_C * v * v * v)
    return v / (1.0 + torch.exp(-2.0 * u))


def _gelu_exp_grad(v):
    """Its derivative from the same s = 1 / (1 + exp(-2u)) (0.5 (1 + tanh)
    = s, 1 - tanh^2 = 4 s (1 - s)): s + 2 k v s (1 - s) (1 + 3 c v^2)."""
    u = _GELU_K * (v + _GELU_C * v * v * v)
    s = 1.0 / (1.0 + torch.exp(-2.0 * u))
    return s + 2.0 * _GELU_K * v * s * (1.0 - s) * (
        1.0 + 3.0 * _GELU_C * v * v)


def _ln_vjp(x, dz, scale, eps):
    """The VJP of LN(x) * (1 + scale) + shift at dz (f32), LN as ``_ln``:
    (dx, dshift, dscale) in f32, the last two summed over each element's
    rows (dim 1). x (B, N, D), dz (B, N, D), scale (B, 1, D)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt(torch.square(xf - mu).mean(dim=-1, keepdim=True) + eps)
    xh = (xf - mu) * rs
    g = dz * (1.0 + scale.float())
    dx = rs * (g - g.mean(dim=-1, keepdim=True)
               - xh * (g * xh).mean(dim=-1, keepdim=True))
    return dx, dz.sum(dim=1), (dz * xh).sum(dim=1)


def mlp_half_bwd_reference(x1, mod, w1, b1, w2, b2, dy, eps: float = 1e-6):
    """Plain twin of the bf16 block backward's MLP-half kernel
    (``mlp_bwd_tc_kernel`` in csrc/dit_block_bwd.cu): the VJP of the
    block's MLP half (``_mlp_half`` in JAX: LN -> modulate(mod[3], mod[4])
    -> fc1 -> tanh-GELU -> fc2 -> gated residual with mod[5]) at dy, with
    the kernel's rounding points, T() rounding to x1's dtype and every
    product summed in f32: z2 = T(modLN(x1)), a1 = T(z2 w1 + b1), h1 =
    T(gelu(a1)), h2 = T(h1 w2 + b2), dh2 = T(T(gate) dy), da1 = T((dh2
    w2^T) gelu'(a1)), dz2 = da1 w1^T; the GELU as the kernel takes it
    (``_gelu_exp``). x1, dy (B, N, D), mod (B, 6, D), the weights in x1's
    dtype. Returns (dx1 = dy + LN-VJP in f32, z2, h1, dh2, da1, dshift_m,
    dscale_m, dgate_m), the last three f32 column sums over each element's
    rows, (B, D)."""
    dt = x1.dtype
    f = lambda t: t.float()
    m = lambda i: mod[:, i, None, :].float()                  # (B, 1, D)
    z2 = _mod_ln(x1, m(3), m(4), eps)
    a1 = (f(z2) @ f(w1) + f(b1)).to(dt)
    h1 = _gelu_exp(f(a1)).to(dt)
    h2 = (f(h1) @ f(w2) + f(b2)).to(dt)
    dgate = (f(dy) * f(h2)).sum(dim=1)
    dh2 = (f(m(5).to(dt)) * f(dy)).to(dt)
    da1 = ((f(dh2) @ f(w2).t()) * _gelu_exp_grad(f(a1))).to(dt)
    dx, dshift, dscale = _ln_vjp(x1, f(da1) @ f(w1).t(), m(4), eps)
    return f(dy) + dx, z2, h1, dh2, da1, dshift, dscale, dgate


def qkv_half_bwd_reference(x, mod, wqkv, dqkv, dx1, eps: float = 1e-6):
    """Plain twin of the bf16 block backward's qkv-half kernel
    (``qkv_bwd_tc_kernel``): the VJP of the block's qkv half (``_dense(
    _mod_ln(x, mod[0], mod[1]), wqkv, bqkv)`` in JAX) at dqkv, added to the
    residual stream's gradient dx1 (f32): dz1 = dqkv wqkv^T in f32, dx =
    T(dx1 + LN-VJP). x (B, N, D), mod (B, 6, D), wqkv (D, 3D) and dqkv
    (B, N, 3D) in x's dtype. Returns (dx, dshift_a, dscale_a), the last two
    f32 column sums over each element's rows, (B, D)."""
    dz = dqkv.float() @ wqkv.float().t()
    dx, dshift, dscale = _ln_vjp(x, dz, mod[:, 1, None, :], eps)
    return (dx1.float() + dx).to(x.dtype), dshift, dscale


def fused_dit_stack_reference(x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1,
                              wfc2, bfc2, num_heads: int, eps: float = 1e-6):
    """Plain PyTorch twin of the stack kernel, on any device."""
    dt = x.dtype
    w = lambda a: a.to(dt)
    for l in range(wqkv.shape[0]):
        x = dit_stack_reference_block(
            x, mod[:, l], w(wqkv[l]), w(bqkv[l]), w(wproj[l]), w(bproj[l]),
            w(wfc1[l]), w(bfc1[l]), w(wfc2[l]), w(bfc2[l]), num_heads, eps)
    return x


def fused_dit_block_reference(x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1,
                              wfc2, bfc2, num_heads: int, eps: float = 1e-6):
    """Plain PyTorch twin of one block with the JAX wrapper's casts: the
    weights enter in their own dtype (f32 params) and are cast to x's dtype
    inside, so autograd over it returns f32 weight grads, dx in x's dtype
    and dmod in mod's dtype, the JAX block-VJP's contract."""
    dt = x.dtype
    ws = [w.to(dt) for w in (wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2,
                             bfc2)]
    return dit_stack_reference_block(x, mod, *ws, num_heads, eps)


# the four GEMM stages of the split block, by their place in it
SPLIT_GEMM_STAGES = ("qkv", "proj", "fc1", "fc2")


def split_gemm_reference(a, mod, w, bias, res, stage: str,
                         eps: float = 1e-6):
    """Plain twin of one GEMM stage of the split block
    (``dit_stack_reference_block``'s step): a (B, N, K), mod (B, 6, D),
    w (K, cols) and bias (cols,) in a's dtype, res (B, N, cols) for the
    residual stages (else unread). "qkv": modLN(a; mod0, mod1) @ w + bias;
    "proj": res + gate2 * (a @ w + bias); "fc1": gelu(modLN(a; mod3,
    mod4) @ w + bias); "fc2": res + gate5 * (a @ w + bias); each dense
    product in f32 with the f32 bias added, then rounded (``_dense``)."""
    m = lambda i: mod[:, i][:, None, :]
    if stage == "qkv":
        return _dense(_mod_ln(a, m(0), m(1), eps), w, bias)
    if stage == "fc1":
        return F.gelu(_dense(_mod_ln(a, m(3), m(4), eps), w, bias),
                      approximate="tanh")
    gate = m(2 if stage == "proj" else 5).to(a.dtype)
    return res + gate * _dense(a, w, bias)


# ------------------------------------------------------------ CUDA kernels

def _kernel_supported(library, check, D, hidden, num_heads, dtype):
    """Ask a block library's own check (``_build.supported``), which
    builds and loads it: needs nvcc and a card."""
    if dtype not in _ENTRY:
        return False
    return _build.supported(library, check, D, hidden, num_heads,
                            int(dtype == torch.bfloat16))


def stack_kernel_supported(D: int, hidden: int, num_heads: int,
                           dtype: torch.dtype) -> bool:
    """Whether the CUDA stack kernel takes this geometry on the current
    device (``dit_stack_check`` in dit_stack.cu)."""
    return _kernel_supported("dit_stack", "dit_stack_check", D, hidden,
                             num_heads, dtype)


def block_kernel_supported(D: int, hidden: int, num_heads: int,
                           dtype: torch.dtype) -> bool:
    """Whether the CUDA block kernels, forward and backward, take this
    geometry on the current device (``dit_block_check`` in
    dit_block_bwd.cu, which checks the forward kernels too)."""
    return _kernel_supported("dit_block_bwd", "dit_block_check", D, hidden,
                             num_heads, dtype)


def split_kernel_supported(D: int, hidden: int, num_heads: int,
                           dtype: torch.dtype) -> bool:
    """Whether the CUDA split block kernel takes this geometry on the
    current device (``dit_split_check`` in dit_split.cu)."""
    return _kernel_supported("dit_split", "dit_split_check", D, hidden,
                             num_heads, dtype)


def _check_shapes(x, mod, ws, kernel=STACK_KERNEL):
    """The kernel indexes every operand from x's (B, N, D), the depth L
    and the MLP width, so a mismatched operand would be read out of
    bounds: refuse it here. mod and the weights carry the layer axis."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got {tuple(x.shape)}")
    B, _, D = x.shape
    L, hidden = ws[0].shape[0], ws[4].shape[-1]
    want = [("mod", mod, (B, L, 6, D)), ("wqkv", ws[0], (L, D, 3 * D)),
            ("bqkv", ws[1], (L, 3 * D)), ("wproj", ws[2], (L, D, D)),
            ("bproj", ws[3], (L, D)), ("wfc1", ws[4], (L, D, hidden)),
            ("bfc1", ws[5], (L, hidden)), ("wfc2", ws[6], (L, hidden, D)),
            ("bfc2", ws[7], (L, D))]
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")


def _refused(name, x, hidden, num_heads):
    B, N, D = x.shape
    return ValueError(
        f"{name} CUDA kernel does not take B={B} N={N} D={D} "
        f"hidden={hidden} heads={num_heads} dtype={x.dtype}")


def _operands(x, mod, ws, num_heads):
    """What every kernel entry takes: x contiguous, mod in f32, the weights
    in x's dtype on x's device, and the softmax scale cast to x's dtype
    (the JAX recipe scales q by it)."""
    dev, dt = x.device, x.dtype
    return (x.contiguous(),
            mod.to(device=dev, dtype=torch.float32).contiguous(),
            [w.to(device=dev, dtype=dt).contiguous() for w in ws],
            float(torch.tensor((x.shape[-1] // num_heads) ** -0.5, dtype=dt)))


def _launch_stack(x, mod, ws, num_heads, eps, name=STACK_KERNEL):
    B, N, D = x.shape
    L = ws[0].shape[0]
    hidden = ws[4].shape[-1]
    refused = _refused(name, x, hidden, num_heads)
    if x.dtype not in _ENTRY:
        raise refused
    lib = _build.load("dit_stack")
    x, mod, ws, qscale = _operands(x, mod, ws, num_heads)
    out, tmp = torch.empty_like(x), torch.empty_like(x)
    qkv = torch.empty((B, N, 3 * D), device=x.device, dtype=x.dtype)
    _build.launch(lib, _ENTRY[x.dtype], name, refused, x.device, x, mod,
                  *ws, out, tmp, qkv, B, N, D, hidden, L, num_heads, eps,
                  qscale)
    return out


def _launch_split(x, mod, ws, num_heads, eps):
    """One block through the five launches of ``csrc/dit_split.cu``; the
    qkv, attention-output, residual and MLP-hidden intermediates are
    allocated here and live for the call only."""
    B, N, D = x.shape
    hidden = ws[4].shape[-1]
    refused = _refused(SPLIT_KERNEL, x, hidden, num_heads)
    if x.dtype not in _SPLIT_ENTRY:
        raise refused
    lib = _build.load("dit_split")
    x, mod, ws, qscale = _operands(x, mod, ws, num_heads)
    out, attn, y1 = (torch.empty_like(x) for _ in range(3))
    qkv = torch.empty((B, N, 3 * D), device=x.device, dtype=x.dtype)
    h1 = torch.empty((B, N, hidden), device=x.device, dtype=x.dtype)
    _build.launch(lib, _SPLIT_ENTRY[x.dtype], SPLIT_KERNEL, refused,
                  x.device, x, mod, *ws, out, qkv, attn, y1, h1, B, N, D,
                  hidden, num_heads, eps, qscale)
    return out


# dit_split_route's answers, by value
_SPLIT_ROUTES = ("none", "narrow", "wide", "persistent")


def split_gemm_route(D: int, rows: int) -> str:
    """Which wgmma route a bf16 split-block call of ``rows`` rows takes at
    width D on the current device (``dit_split_route``): "persistent" (qkv,
    proj and fc1 on csrc/split_tc.cuh's persistent kernel, fc2 on
    wg_gemm.cuh's 128-row blocks: D 128, 256 and 512 at more rows than one
    128-row tile a SM, 16,896 on a 132-SM H100), else its LayerNorm GEMMs'
    route on wg_gemm.cuh for all four: "wide" (128-row blocks, 128-column
    steps), "narrow" (64-row blocks, 64-column steps) or "none"."""
    return _SPLIT_ROUTES[_build.load("dit_split").dit_split_route(D, rows)]


def _launch_split_gemm(a, mod, w, bias, res, stage, eps=1e-6):
    """One bf16 GEMM stage of the split block alone (the block's launches
    run the same kernels), with ``split_gemm_reference``'s operands; counted
    as ``split_gemm``. For measurements and tests."""
    B, N, K = a.shape
    cols = w.shape[-1]
    resid = stage in ("proj", "fc2")
    want = [("w", w, (K, cols)), ("bias", bias, (cols,)),
            ("mod", mod, (B, 6, cols if resid else K))]
    if resid:
        want.append(("res", res, (B, N, cols)))
    for name, t, shape in want:
        if t is None or tuple(t.shape) != shape:
            got = None if t is None else tuple(t.shape)
            raise ValueError(f"{SPLIT_GEMM_KERNEL} {stage}: {name} must be "
                             f"{shape}, got {got}")
    refused = ValueError(f"{SPLIT_GEMM_KERNEL} {stage} does not take "
                         f"B={B} N={N} K={K} cols={cols} dtype={a.dtype}")
    if a.dtype != torch.bfloat16:
        raise refused
    lib = _build.load("dit_split")
    out = torch.empty((B, N, cols), device=a.device, dtype=a.dtype)
    res = res.contiguous() if resid else out
    _build.launch(lib, "dit_split_gemm_bf16", SPLIT_GEMM_KERNEL, refused,
                  a.device, a.contiguous(), mod.float().contiguous(),
                  w.contiguous(), bias.contiguous(), res, out, B * N, N, K,
                  cols, SPLIT_GEMM_STAGES.index(stage), float(eps))
    return out


def _launch_block_bwd(x, mod, ws, dy, num_heads, eps):
    """dx (x's dtype), dmod (f32) and the eight f32 weight and bias grads
    of one block, from the hand-written backward (which recomputes the
    forward from these inputs, as the JAX kernel does)."""
    B, N, D = x.shape
    hidden = ws[4].shape[-1]
    dt = x.dtype
    refused = _refused(BLOCK_BWD_KERNEL, x, hidden, num_heads)
    if dt not in _BWD_ENTRY:
        raise refused
    lib = _build.load("dit_block_bwd")
    dev = x.device
    is_bf16 = int(dt == torch.bfloat16)
    if lib.dit_block_check(D, hidden, num_heads, is_bf16) == \
            _build.UNSUPPORTED_SHAPE:
        raise refused
    x, mod, ws, qscale = _operands(x, mod, ws, num_heads)
    dy = dy.to(dtype=dt).contiguous()
    dx = torch.empty_like(x)
    dmod = torch.empty((B, 6, D), device=dev, dtype=torch.float32)
    dws = [torch.empty(w.shape, device=dev, dtype=torch.float32) for w in ws]
    work = torch.empty(lib.dit_block_backward_workspace(
        B, N, D, hidden, num_heads, is_bf16), device=dev, dtype=torch.uint8)
    _build.launch(lib, _BWD_ENTRY[dt], BLOCK_BWD_KERNEL, refused, dev, x,
                  mod, *ws, dy, dx, dmod, *dws, work, B, N, D, hidden,
                  num_heads, eps, qscale)
    return dx, dmod, dws


def _row_bwd_refused(name, x, D, hidden):
    B, N = x.shape[:2]
    return ValueError(f"{name} CUDA kernel does not take B={B} N={N} D={D} "
                      f"hidden={hidden} dtype={x.dtype}")


def _check_row_bwd(name, want):
    for what, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {shape}, got "
                             f"{tuple(t.shape)}")


def _launch_mlp_half_bwd(x1, mod, w1, b1, w2, b2, dy, eps: float = 1e-6):
    """The bf16 block backward's MLP-half kernel alone (the C entry
    ``dit_block_mlp_bwd_bf16``; the backward launches the same kernel), on
    ``mlp_half_bwd_reference``'s operands, returning what the twin returns:
    the kernel's per-tile column sums summed over each element's tiles.
    Counted as ``mlp_half_bwd``. For checks and measurements."""
    B, N, D = x1.shape
    hidden = w1.shape[-1]
    refused = _row_bwd_refused(MLP_HALF_BWD_KERNEL, x1, D, hidden)
    _check_row_bwd(MLP_HALF_BWD_KERNEL, [
        ("mod", mod, (B, 6, D)), ("w1", w1, (D, hidden)),
        ("b1", b1, (hidden,)), ("w2", w2, (hidden, D)), ("b2", b2, (D,)),
        ("dy", dy, (B, N, D))])
    if x1.dtype != torch.bfloat16:
        raise refused
    lib = _build.load("dit_block_bwd")
    dev, dt = x1.device, x1.dtype
    c = lambda t: t.to(device=dev, dtype=dt).contiguous()
    dx1 = torch.empty((B, N, D), device=dev, dtype=torch.float32)
    z2, dh2 = torch.empty_like(x1), torch.empty_like(x1)
    h1, da1 = (torch.empty((B, N, hidden), device=dev, dtype=dt)
               for _ in range(2))
    part = torch.zeros((B, -(-N // 64), 6, D), device=dev,
                       dtype=torch.float32)
    _build.launch(lib, "dit_block_mlp_bwd_bf16", MLP_HALF_BWD_KERNEL,
                  refused, dev, c(x1),
                  mod.to(device=dev, dtype=torch.float32).contiguous(),
                  c(w1), c(b1), c(w2), c(b2), c(dy), dx1, z2, h1, dh2, da1,
                  part, B, N, D, hidden, float(eps))
    sums = part.sum(dim=1)
    return dx1, z2, h1, dh2, da1, sums[:, 3], sums[:, 4], sums[:, 5]


def _launch_qkv_half_bwd(x, mod, wqkv, dqkv, dx1, eps: float = 1e-6):
    """The bf16 block backward's qkv-half kernel alone (the C entry
    ``dit_block_qkv_bwd_bf16``), on ``qkv_half_bwd_reference``'s operands,
    returning what the twin returns. Counted as ``qkv_half_bwd``. For
    checks and measurements."""
    B, N, D = x.shape
    refused = _row_bwd_refused(QKV_HALF_BWD_KERNEL, x, D, 3 * D)
    _check_row_bwd(QKV_HALF_BWD_KERNEL, [
        ("mod", mod, (B, 6, D)), ("wqkv", wqkv, (D, 3 * D)),
        ("dqkv", dqkv, (B, N, 3 * D)), ("dx1", dx1, (B, N, D))])
    if x.dtype != torch.bfloat16:
        raise refused
    lib = _build.load("dit_block_bwd")
    dev, dt = x.device, x.dtype
    c = lambda t: t.to(device=dev, dtype=dt).contiguous()
    dx = torch.empty_like(x)
    part = torch.zeros((B, -(-N // 64), 6, D), device=dev,
                       dtype=torch.float32)
    _build.launch(lib, "dit_block_qkv_bwd_bf16", QKV_HALF_BWD_KERNEL,
                  refused, dev, c(x),
                  mod.to(device=dev, dtype=torch.float32).contiguous(),
                  c(wqkv), c(dqkv),
                  dx1.to(device=dev, dtype=torch.float32).contiguous(), dx,
                  part, B, N, D, float(eps))
    sums = part.sum(dim=1)
    return dx, sums[:, 0], sums[:, 1]


def fused_dit_stack(x: torch.Tensor, mod: torch.Tensor, wqkv, bqkv, wproj,
                    bproj, wfc1, bfc1, wfc2, bfc2, num_heads: int,
                    eps: float = 1e-6, attn_impl: str = "loop",
                    batch_block: int = 1) -> torch.Tensor:
    """Whole transformer stack: x (B, N, D), mod (B, L, 6, D), weights
    stacked over L in flax layout. CUDA tensor -> hand-written kernel;
    CPU tensor -> the plain twin.

    JAX's two opt-in variants are taken and compute the same function as
    the default: ``batch_block`` G > 1 gives each TPU program a (G, N, D)
    slab so the dense layers run on G*N rows (``_stack_kernel_g``), and
    ``attn_impl='folded'`` computes all heads' scores and PV as two
    block-diagonal MXU products (``attn_heads_folded``); any other
    ``attn_impl`` is the per-head loop, as in JAX. The CUDA kernel already
    runs every dense layer over all B*N rows in 64-row tiles across the
    grid and holds no (N, N) matrix, so both run its usual launches,
    counted as ``fused_dit_stack``. As in JAX, G must divide B."""
    if x.shape[0] % batch_block:
        raise ValueError(f"batch_block {batch_block} must divide batch "
                         f"{x.shape[0]}")
    ws = (wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2)
    _check_shapes(x, mod, ws)
    if x.is_cuda:
        _build.refuse_autograd(STACK_KERNEL, (x, mod, *ws),
                         "models.denoisers.dit_fast.fast_dit_train_forward")
        return _launch_stack(x, mod, ws, num_heads, eps)
    if x.device.type != "cpu":
        raise ValueError(f"fused_dit_stack: unsupported device {x.device}")
    return fused_dit_stack_reference(x, mod, *ws, num_heads, eps)


def fused_dit_block(x: torch.Tensor, mod: torch.Tensor, wqkv, bqkv, wproj,
                    bproj, wfc1, bfc1, wfc2, bfc2, num_heads: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """One adaLN-zero block: x (B, N, D), mod (B, 6, D), flax-layout
    weights in any float dtype (cast to x's). CUDA tensor -> the stack's
    kernels with L = 1, counted as ``fused_dit_block``; CPU tensor -> the
    plain twin. Not differentiable on CUDA (it raises under grad mode when
    an input requires grad): train through ``fused_dit_block_diffable``."""
    ws = (wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2)
    if mod.dim() != 3:
        raise ValueError(f"fused_dit_block: mod must be (B, 6, D), got "
                         f"{tuple(mod.shape)}")
    stacked = tuple(w[None] for w in ws)
    _check_shapes(x, mod[:, None], stacked, BLOCK_KERNEL)
    if x.is_cuda:
        _build.refuse_autograd(BLOCK_KERNEL, (x, mod, *ws),
                         "fused_dit_block_diffable")
        return _launch_stack(x, mod[:, None], stacked, num_heads, eps,
                             BLOCK_KERNEL)
    if x.device.type != "cpu":
        raise ValueError(f"fused_dit_block: unsupported device {x.device}")
    return fused_dit_block_reference(x, mod, *ws, num_heads, eps)


def fused_dit_block_split(x: torch.Tensor, mod: torch.Tensor, wqkv, bqkv,
                          wproj, bproj, wfc1, bfc1, wfc2, bfc2,
                          num_heads: int, eps: float = 1e-6,
                          block_q: int = 0) -> torch.Tensor:
    """One adaLN-zero block for wide geometries (the scaled DiT's d_model
    512): x (B, N, D), mod (B, 6, D), flax-layout weights in any float
    dtype (cast to x's). CUDA tensor -> the five launches of
    ``csrc/dit_split.cu``, counted once as ``fused_dit_block_split``; CPU
    tensor -> the block's plain twin (``fused_dit_block_reference``: the
    same math). ``block_q`` is the JAX signature's q row-block: the CUDA
    kernels pick their own tiles and the twin needs none, so it is ignored.
    Forward only: on CUDA it raises under grad mode when an input requires
    grad."""
    del block_q
    ws = (wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2)
    if mod.dim() != 3:
        raise ValueError(f"{SPLIT_KERNEL}: mod must be (B, 6, D), got "
                         f"{tuple(mod.shape)}")
    _check_shapes(x, mod[:, None], tuple(w[None] for w in ws), SPLIT_KERNEL)
    if x.is_cuda:
        _build.refuse_autograd(SPLIT_KERNEL, (x, mod, *ws),
                         "fused_dit_block_diffable")
        return _launch_split(x, mod, ws, num_heads, eps)
    if x.device.type != "cpu":
        raise ValueError(f"{SPLIT_KERNEL}: unsupported device {x.device}")
    return fused_dit_block_reference(x, mod, *ws, num_heads, eps)


class _FusedBlock(torch.autograd.Function):
    """Forward: ``fused_dit_block``. Backward: the hand-written kernel on
    CUDA, autograd over the plain twin on the CPU. Only the inputs are
    saved; the backward recomputes the forward (the JAX kernel's
    residuals are its inputs too)."""

    @staticmethod
    def forward(ctx, x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2,
                bfc2, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1,
                              wfc2, bfc2)
        return fused_dit_block(x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1,
                               wfc2, bfc2, num_heads)

    @staticmethod
    def backward(ctx, dy):
        x, mod, *ws = ctx.saved_tensors
        if x.is_cuda:
            dx, dmod, dws = _launch_block_bwd(x, mod, ws, dy, ctx.num_heads,
                                              1e-6)
            grads = [dx, dmod.to(mod.dtype),
                     *(d.to(w.dtype) for d, w in zip(dws, ws))]
        else:
            with torch.enable_grad():
                inp = [t.detach().requires_grad_() for t in (x, mod, *ws)]
                out = fused_dit_block_reference(*inp, ctx.num_heads)
                grads = torch.autograd.grad(out, inp, dy)
        return (*grads, None)


def fused_dit_block_diffable(x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1,
                             wfc2, bfc2, num_heads: int) -> torch.Tensor:
    """Differentiable block with the JAX gradient contract: dx in x's
    dtype, dmod in mod's own dtype, weight and bias grads in each weight's
    dtype (f32 for f32 params). Pass the weights as views of the
    parameters (``lin.weight.t()``) so the grads reach them."""
    return _FusedBlock.apply(x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1,
                             wfc2, bfc2, num_heads)


# ------------------------------------------------ LayerNorm + modulate

def mod_ln_reference(x: torch.Tensor, mod2: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Plain twin of ``_mod_ln_call``: x (B, N, D), mod2 (B, 2, D) =
    [shift, scale]; f32 LayerNorm, modulate in f32, one rounding to x's
    dtype (the shared ``_mod_ln``)."""
    return _mod_ln(x, mod2[:, 0, None], mod2[:, 1, None], eps)


def mod_ln_supported(D: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA LayerNorm + modulate kernels, forward and
    backward, take rows of D values in ``dtype`` (``mod_ln_check`` in
    mod_ln.cu). The JAX VMEM envelope (``mod_ln_block_q``) is not
    ported."""
    if dtype not in _MOD_LN_ENTRY:
        return False
    return _build.supported("mod_ln", "mod_ln_check", D,
                            int(dtype == torch.bfloat16))


def _check_mod2(x, mod2):
    if x.dim() != 3 or tuple(mod2.shape) != (x.shape[0], 2, x.shape[2]):
        raise ValueError(f"{MOD_LN_KERNEL}: x must be (B, N, D) and mod2 "
                         f"(B, 2, D), got {tuple(x.shape)} and "
                         f"{tuple(mod2.shape)}")


def _rows(t, dt):
    """A (B, N, D) operand as the LayerNorm kernels read it: in ``dt``,
    contiguous, 16-byte aligned (the bf16 kernels move 16-byte chunks)."""
    t = t.to(dtype=dt).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _refused_rows(name, x):
    B, N, D = x.shape
    return ValueError(f"{name} CUDA kernel does not take B={B} N={N} D={D} "
                      f"dtype={x.dtype}")


def _ln_operands(name, x):
    """The LayerNorm library and x as its entries take it (``_rows``); a
    dtype they do not take is refused here, a shape by the launch (which
    builds the refusal only then)."""
    if x.dtype not in _MOD_LN_ENTRY:
        raise _refused_rows(name, x)
    return _build.load("mod_ln"), _rows(x, x.dtype)


def _mod_in_place(x, mod):
    """The per-sample vectors (mod2 or gm3, (B, k, D)) as #5-#8 read them
    in place: bf16 or f32 (another dtype goes over in f32), rows of D
    contiguous, at any batch stride (the flax path's views of the (B, 6, D)
    modulation go over as they are); with that stride and whether they are
    bf16."""
    if mod.dtype not in _MOD_LN_ENTRY or mod.device != x.device:
        mod = mod.to(device=x.device, dtype=torch.float32)
    if mod.stride(2) != 1 or mod.stride(1) != mod.shape[2]:
        mod = mod.contiguous()
    return mod, mod.stride(0), int(mod.dtype == torch.bfloat16)


def _launch_mod_ln(x, mod2, eps):
    """out in x's dtype; the kernel reads mod2 in place (bf16 or f32, at
    its batch stride: the flax path's view of the modulation)."""
    lib, x = _ln_operands(MOD_LN_KERNEL, x)
    m, ms, mbf16 = _mod_in_place(x, mod2)
    out = torch.empty_like(x)
    _build.launch(lib, _MOD_LN_ENTRY[x.dtype], MOD_LN_KERNEL,
                  lambda: _refused_rows(MOD_LN_KERNEL, x), x.device, x,
                  m, ms, mbf16, out, *x.shape, float(eps))
    return out


def _launch_mod_ln_bwd(x, mod2, dy, eps):
    """dx in x's dtype and dmod2 in mod2's: the kernel reads mod2 in place,
    sums dshift and dscale in f32 and rounds them once to mod2's dtype
    (bf16 or f32; another dtype gets f32 sums, rounded here)."""
    lib, x = _ln_operands(MOD_LN_BWD_KERNEL, x)
    dy = _rows(dy, x.dtype)
    m, ms, mbf16 = _mod_in_place(x, mod2)
    dx = torch.empty_like(x)
    dmod = torch.empty(m.shape, device=x.device, dtype=m.dtype)
    work = torch.empty(lib.mod_ln_backward_workspace(*x.shape),
                       device=x.device, dtype=torch.uint8)
    _build.launch(lib, _MOD_LN_BWD_ENTRY[x.dtype], MOD_LN_BWD_KERNEL,
                  lambda: _refused_rows(MOD_LN_BWD_KERNEL, x), x.device, x,
                  m, ms, mbf16, dy, dx, dmod, work, *x.shape, float(eps))
    return dx, dmod.to(mod2.dtype)


def _mod_ln_call(x, mod2, eps):
    """The forward: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_mod2(x, mod2)
    if x.is_cuda:
        return _launch_mod_ln(x, mod2, eps)
    if x.device.type != "cpu":
        raise ValueError(f"{MOD_LN_KERNEL}: unsupported device {x.device}")
    return mod_ln_reference(x, mod2, eps)


class _ModLn(torch.autograd.Function):
    """Forward ``_mod_ln_call``; backward the hand-written kernel on CUDA,
    autograd over the twin on the CPU. The residuals are the inputs, as in
    the JAX kernel."""

    @staticmethod
    def forward(ctx, x, mod2, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, mod2)
        return _mod_ln_call(x, mod2, eps)

    @staticmethod
    def backward(ctx, dy):
        x, mod2 = ctx.saved_tensors
        if x.is_cuda:
            dx, dmod = _launch_mod_ln_bwd(x, mod2, dy, ctx.eps)
        else:
            with torch.enable_grad():
                inp = [t.detach().requires_grad_() for t in (x, mod2)]
                dx, dmod = torch.autograd.grad(
                    mod_ln_reference(*inp, ctx.eps), inp, dy)
        return dx, dmod, None


def mod_ln_diffable(x: torch.Tensor, mod2: torch.Tensor, eps: float = 1e-6,
                    block_q: int = 0) -> torch.Tensor:
    """Differentiable LayerNorm (no scale or bias) + adaLN modulate with
    the JAX contract: x (B, N, D), mod2 (B, 2, D) = [shift, scale] ->
    (B, N, D) in x's dtype; dx in x's dtype, dmod2 in mod2's. CUDA tensor
    -> ``csrc/mod_ln.cu`` both ways; CPU tensor -> the twin. ``block_q``
    is the JAX signature's q row-block: the kernels pick their own tiles,
    so it is ignored."""
    del block_q
    return _ModLn.apply(x, mod2, eps)


# ------------------------------- gated residual + LayerNorm + modulate

def res_mod_ln_reference(x: torch.Tensor, h: torch.Tensor, gm3: torch.Tensor,
                         eps: float = 1e-6):
    """Plain twin of ``_res_mod_ln_call``: y = x + gate * h in x's dtype
    (the gate cast to it first, as the eager block's gated residual), then
    ``mod_ln_reference`` of y with gm3 = [gate, shift, scale] (B, 3, D).
    Returns (modulated, y)."""
    y = x + gm3[:, 0, None].to(x.dtype) * h
    return _mod_ln(y, gm3[:, 1, None], gm3[:, 2, None], eps), y


def res_mod_ln_supported(D: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA gated-residual + LayerNorm + modulate kernels,
    forward and backward, take rows of D values in ``dtype``
    (``res_mod_ln_check`` in mod_ln.cu). The JAX VMEM envelope
    (``res_mod_ln_block_q``) is not ported."""
    if dtype not in _RES_ENTRY:
        return False
    return _build.supported("mod_ln", "res_mod_ln_check", D,
                            int(dtype == torch.bfloat16))


def _check_gm3(x, h, gm3):
    if (x.dim() != 3 or h.shape != x.shape
            or tuple(gm3.shape) != (x.shape[0], 3, x.shape[2])):
        raise ValueError(f"{RES_MOD_LN_KERNEL}: x and h must be (B, N, D) "
                         f"and gm3 (B, 3, D), got {tuple(x.shape)}, "
                         f"{tuple(h.shape)} and {tuple(gm3.shape)}")


def _launch_res_mod_ln(x, h, gm3, eps):
    """(out, y) in x's dtype; the kernel reads gm3 in place (bf16 or f32,
    at its batch stride: the flax path's view of the modulation)."""
    lib, x = _ln_operands(RES_MOD_LN_KERNEL, x)
    h = _rows(h, x.dtype)
    m, ms, mbf16 = _mod_in_place(x, gm3)
    out, y = torch.empty_like(x), torch.empty_like(x)
    _build.launch(lib, _RES_ENTRY[x.dtype], RES_MOD_LN_KERNEL,
                  lambda: _refused_rows(RES_MOD_LN_KERNEL, x), x.device, x,
                  h, m, ms, mbf16, out, y, *x.shape, float(eps))
    return out, y


def _launch_res_mod_ln_bwd(x, h, gm3, do, dy, eps):
    """dx in x's dtype, dh in h's and dgm3 in gm3's: the kernel reads gm3
    in place, sums dgate, dshift and dscale in f32 and rounds them once to
    gm3's dtype (bf16 or f32; another dtype gets f32 sums, rounded
    here)."""
    lib, xc = _ln_operands(RES_MOD_LN_BWD_KERNEL, x)
    dt = xc.dtype
    m, ms, mbf16 = _mod_in_place(xc, gm3)
    hc, do, dy = (_rows(t, dt) for t in (h, do, dy))
    dx, dh = torch.empty_like(xc), torch.empty_like(xc)
    dgm = torch.empty(m.shape, device=x.device, dtype=m.dtype)
    work = torch.empty(lib.res_mod_ln_backward_workspace(*x.shape),
                       device=x.device, dtype=torch.uint8)
    _build.launch(lib, _RES_BWD_ENTRY[dt], RES_MOD_LN_BWD_KERNEL,
                  lambda: _refused_rows(RES_MOD_LN_BWD_KERNEL, xc), x.device,
                  xc, hc, m, ms, mbf16, do, dy, dx, dh, dgm, work, *x.shape,
                  float(eps))
    return dx, dh.to(h.dtype), dgm.to(gm3.dtype)


def _res_mod_ln_call(x, h, gm3, eps):
    """The forward: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_gm3(x, h, gm3)
    if x.is_cuda:
        return _launch_res_mod_ln(x, h, gm3, eps)
    if x.device.type != "cpu":
        raise ValueError(f"{RES_MOD_LN_KERNEL}: unsupported device "
                         f"{x.device}")
    return res_mod_ln_reference(x, h, gm3, eps)


class _ResModLn(torch.autograd.Function):
    """Forward ``_res_mod_ln_call``; backward the hand-written kernel on
    CUDA, autograd over the twin on the CPU, with both outputs'
    cotangents. The residuals are the inputs, as in the JAX kernel."""

    @staticmethod
    def forward(ctx, x, h, gm3, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, h, gm3)
        return _res_mod_ln_call(x, h, gm3, eps)

    @staticmethod
    def backward(ctx, do, dy):
        x, h, gm3 = ctx.saved_tensors
        if x.is_cuda:
            dx, dh, dgm = _launch_res_mod_ln_bwd(x, h, gm3, do, dy, ctx.eps)
        else:
            with torch.enable_grad():
                inp = [t.detach().requires_grad_() for t in (x, h, gm3)]
                dx, dh, dgm = torch.autograd.grad(
                    res_mod_ln_reference(*inp, ctx.eps), inp, (do, dy))
        return dx, dh, dgm, None


def res_mod_ln_diffable(x: torch.Tensor, h: torch.Tensor, gm3: torch.Tensor,
                        eps: float = 1e-6, block_q: int = 0):
    """Differentiable adaLN-zero block boundary with the JAX contract: the
    gated residual y = x + gate * h, then LayerNorm (no scale or bias) +
    modulate; x, h (B, N, D), gm3 (B, 3, D) = [gate, shift, scale] ->
    (modulated, y), both in x's dtype; dx in x's dtype, dh in h's, dgm3 in
    gm3's. CUDA tensor -> ``csrc/mod_ln.cu`` both ways; CPU tensor -> the
    twin. ``block_q`` is the JAX signature's q row-block: the kernels pick
    their own tiles, so it is ignored."""
    del block_q
    return _ResModLn.apply(x, h, gm3, eps)
