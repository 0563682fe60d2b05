"""TS2Vec in PyTorch, the contrastive encoder behind C-FID (counterpart of
t2ms_tpu/evaluate/ts2vec.py).

Reference: evaluate/ts2vec.py (618 LoC torch): dilated-conv encoder
(:352-450), hierarchical instance+temporal contrastive loss (:452-497),
SWA-averaged network (:64-65), random-crop training (:127-141), and
``encode(..., encoding_window='full_series')`` max-pooling (:175-217).
``initialize_ts2vec`` (:12-21) trains it on the eval data itself
(batch 8, lr 1e-3, output_dims 100).

The JAX package runs the whole fit as one ``lax.scan`` over fixed-length
buffers (roll + NaN mask, a traced crop length, the masked loss). The
port runs an eager loop, as the reference does: each iteration gathers
exact-shape windows and takes ``hierarchical_contrastive_loss`` on the
``crop_l`` overlap, which equals JAX's masked loss for every crop length
(both losses are here, and held to JAX in the tests). What is kept from
JAX:

  * the host draws, call for call: ``np.random.default_rng(seed)``, then
    per batch ``permutation``, the window ``integers``, ``crop_l``,
    ``crop_left``, ``crop_eleft``, ``crop_eright``, ``offsets``
    (``_draw_windows``), so rows and crops match JAX's bit for bit;
  * ``pad_keep``: NaN-padded positions are re-zeroed after every conv and
    the projector (JAX's deliberate deviation from the reference);
  * AdamW with torch's weight decay 0.01, and SWA whose mean includes the
    init weights (``swa_n`` starts at 1: avg += (p - avg) / (n + 1));
  * the cumulative iteration and epoch counters, and only completed
    epochs logged.

torch cannot reproduce JAX's threefry draws, so the encoder takes the
binomial ``mask`` (p 0.5, on ``input_fc``'s output, AND-ed with the NaN
mask) and the dropout ``keep`` (p 0.9, scaled by 1/0.9) as optional
tensors, and ``fit`` takes every iteration's four of them as ``draws``;
otherwise they come from the model's generator. Parameters and compute
are f32; on the card convs and matmuls run with TF32 off inside the
model's calls only (``_exact_f32``), so a C-FID does not depend on the
process's TF32 settings. ``save``/``load`` write a torch state_dict of
the SWA weights (JAX pickles its param tree).
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from t2ms_tpu_torch import resolve_device

__all__ = ["TS2Vec", "initialize_ts2vec", "TSEncoder",
           "instance_contrastive_loss", "temporal_contrastive_loss",
           "hierarchical_contrastive_loss",
           "hierarchical_contrastive_loss_masked"]


@contextlib.contextmanager
def _exact_f32():
    """cuDNN convs and cuBLAS matmuls in full f32 (no TF32, no cuDNN
    autotune: the crop length changes every iteration) for the block, the
    process's settings restored afterwards."""
    cudnn = torch.backends.cudnn
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(precision)


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> None:
    """flax's Dense init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class _ConvBlock(nn.Module):
    """gelu -> conv -> gelu -> conv with the residual, through a 1x1
    projector when the width changes or on the final block (reference
    ConvBlock :420-433). k=3 convs with padding = dilation keep the
    length; where the dilation reaches past the series the outer taps
    read zeros."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int, final: bool):
        super().__init__()
        self.conv1 = nn.Conv1d(in_ch, out_ch, 3, padding=dilation,
                               dilation=dilation)
        self.conv2 = nn.Conv1d(out_ch, out_ch, 3, padding=dilation,
                               dilation=dilation)
        self.projector = (nn.Linear(in_ch, out_ch)
                          if in_ch != out_ch or final else None)

    def forward(self, x, pad_keep):
        def keep(h):
            return torch.where(pad_keep, h, 0.0)
        residual = x
        if self.projector is not None:
            residual = keep(self.projector(x.transpose(1, 2)).transpose(1, 2))
        h = keep(self.conv1(F.gelu(x)))
        h = keep(self.conv2(F.gelu(h)))
        return h + residual


class TSEncoder(nn.Module):
    """input fc -> binomial mask -> dilated conv stack -> dropout
    (reference TSEncoder :352-399). Block i has dilation 2**i; there are
    ``depth`` blocks of ``hidden_dims`` and a final one of
    ``output_dims``. Initialised as flax initialises JAX's: convs
    uniform(+-1/sqrt(fan_in)) (torch's default is the same), Dense
    lecun-normal, biases zero."""

    def __init__(self, input_dims: int, output_dims: int = 320,
                 hidden_dims: int = 64, depth: int = 10, device=None):
        super().__init__()
        self.input_fc = nn.Linear(input_dims, hidden_dims)
        channels = [hidden_dims] * depth + [output_dims]
        blocks, prev = [], hidden_dims
        for i, ch in enumerate(channels):
            blocks.append(_ConvBlock(prev, ch, 2 ** i,
                                     final=(i == len(channels) - 1)))
            prev = ch
        self.blocks = nn.ModuleList(blocks)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    _lecun_normal_(m.weight, m.in_features)
                    m.bias.zero_()
                elif isinstance(m, nn.Conv1d):
                    m.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, input_dims), NaN where padded -> (B, T, output_dims).
        ``mask`` (B, T) bool: the timestamp mask of training (None: all
        kept); ``keep`` (B, T, output_dims) bool: the dropout draw (None:
        no dropout)."""
        nan_mask = ~torch.isnan(x).any(dim=-1)              # (B, T)
        x = torch.where(torch.isnan(x), 0.0, x)
        h = self.input_fc(x)
        m = nan_mask if mask is None else mask & nan_mask
        h = torch.where(m[:, :, None], h, 0.0).transpose(1, 2)
        pad_keep = nan_mask[:, None, :]
        for block in self.blocks:
            h = block(h, pad_keep)
        h = h.transpose(1, 2)
        if keep is not None:
            h = torch.where(keep, h / 0.9, 0.0)
        return h


def _pair_logits(z: torch.Tensor) -> torch.Tensor:
    """z (G, 2M, C) -> (G, 2M, 2M-1) similarities with the diagonal
    dropped: column j of row i is original column j (j < i) else j + 1."""
    sim = z @ z.transpose(1, 2)
    return torch.tril(sim, diagonal=-1)[:, :, :-1] + torch.triu(
        sim, diagonal=1)[:, :, 1:]


def _off_diagonal_logsoftmax_loss(z: torch.Tensor) -> torch.Tensor:
    """Mean NCE loss pairing row i with row M+i (reference :470-497): the
    positive of row i sits at column M+i-1, that of row M+i at column i."""
    M = z.shape[1] // 2
    logits = -F.log_softmax(_pair_logits(z), dim=-1)
    i = torch.arange(M, device=z.device)
    return (logits[:, i, M + i - 1].mean() + logits[:, M + i, i].mean()) / 2


def instance_contrastive_loss(z1, z2):
    if z1.shape[0] == 1:
        return z1.new_zeros(())
    z = torch.cat([z1, z2], dim=0)                      # (2B, T, C)
    return _off_diagonal_logsoftmax_loss(z.transpose(0, 1))


def temporal_contrastive_loss(z1, z2):
    if z1.shape[1] == 1:
        return z1.new_zeros(())
    return _off_diagonal_logsoftmax_loss(torch.cat([z1, z2], dim=1))


def _halve(z: torch.Tensor) -> torch.Tensor:
    """Paired max-pool over time, the odd tail dropped."""
    T2 = (z.shape[1] // 2) * 2
    return z[:, :T2].reshape(z.shape[0], -1, 2, z.shape[2]).amax(dim=2)


def hierarchical_contrastive_loss(z1, z2, alpha=0.5, temporal_unit=0):
    """Multi-scale loss halving T by max-pool each level (reference
    :452-468)."""
    loss = z1.new_zeros(())
    d = 0
    while z1.shape[1] > 1:
        if alpha != 0:
            loss = loss + alpha * instance_contrastive_loss(z1, z2)
        if d >= temporal_unit and 1 - alpha != 0:
            loss = loss + (1 - alpha) * temporal_contrastive_loss(z1, z2)
        d += 1
        z1, z2 = _halve(z1), _halve(z2)
    if z1.shape[1] == 1:
        if alpha != 0:
            loss = loss + alpha * instance_contrastive_loss(z1, z2)
        d += 1
    return loss / d


def _masked_pair_loss(z, group_valid, member_valid):
    """``_off_diagonal_logsoftmax_loss`` where only ``group_valid`` (G,)
    groups and ``member_valid`` (M,) members of each half are real:
    invalid members are zeroed out of the similarity, their softmax
    columns set to -1e30 (finite, so gradients stay clean; f32 only), and
    the pair mean runs over the valid (group, member) grid."""
    twoM = z.shape[1]
    M = twoM // 2
    mv2 = torch.cat([member_valid, member_valid])
    z = torch.where(mv2[None, :, None], z, 0.0)
    i_idx = torch.arange(twoM, device=z.device)[:, None]
    j_idx = torch.arange(twoM - 1, device=z.device)[None, :]
    colmask = mv2[j_idx + (j_idx >= i_idx).long()]
    logits = torch.where(colmask[None], _pair_logits(z), -1e30)
    logp = -F.log_softmax(logits, dim=-1)
    i = torch.arange(M, device=z.device)
    w = group_valid[:, None] & member_valid[None, :]
    denom = torch.clamp(w.sum(), min=1)
    return (torch.where(w, logp[:, i, M + i - 1], 0.0).sum()
            + torch.where(w, logp[:, M + i, i], 0.0).sum()) / (2 * denom)


def hierarchical_contrastive_loss_masked(z1, z2, crop_l, alpha=0.5,
                                         temporal_unit=0):
    """``hierarchical_contrastive_loss`` where only the first ``crop_l``
    time positions of z1/z2 (B, T_max, C) are real: equal to the exact
    loss on (B, crop_l, C) for every crop_l. The buffer halves while the
    valid length halves with it; each level's terms count only while
    that level is live."""
    B, _, C = z1.shape
    dev = z1.device
    loss = z1.new_zeros(())
    d_total = z1.new_zeros(())
    length = torch.as_tensor(crop_l, device=dev)
    all_b = torch.ones(B, dtype=torch.bool, device=dev)
    d = 0
    while True:
        T_d = z1.shape[1]
        pos_valid = torch.arange(T_d, device=dev) < length
        live = (length >= 1).to(z1.dtype)
        d_total = d_total + live
        if alpha != 0 and B > 1:
            z = torch.cat([z1, z2], dim=0).transpose(0, 1)
            loss = loss + alpha * live * _masked_pair_loss(z, pos_valid,
                                                           all_b)
        if d >= temporal_unit and alpha != 1 and T_d > 1:
            z = torch.cat([z1, z2], dim=1)
            t_live = (length > 1).to(z1.dtype)
            loss = loss + (1 - alpha) * t_live * _masked_pair_loss(
                z, all_b, pos_valid)
        if T_d == 1:
            break
        z1 = _halve(torch.where(pos_valid[None, :, None], z1, 0.0))
        z2 = _halve(torch.where(pos_valid[None, :, None], z2, 0.0))
        length = length // 2
        d += 1
    return loss / torch.clamp(d_total, min=1.0)


def _draw_windows(rng: np.random.Generator, n: int, bs: int, ts_l: int,
                  eff_l: int, temporal_unit: int,
                  n_iters: int) -> Dict[str, np.ndarray]:
    """Every iteration's rows and crop geometry, drawn on the host in the
    JAX package's order (its ``fit``, after the reference :127-133): per
    batch of a permutation, the max_train_length window start (when the
    buffer is longer), crop_l, crop_left, crop_eleft, crop_eright, then
    the per-row offsets. Window 1 is [w1_start, w1_start + w1_len) of the
    row, window 2 [w2_start, w2_start + w2_len); their overlap is the last
    crop_l of window 1 (from s1) and the first crop_l of window 2."""
    out = {k: np.empty((n_iters, bs), np.int32)
           for k in ("idx", "w1_start", "w2_start")}
    out.update({k: np.empty((n_iters,), np.int32)
                for k in ("w1_len", "w2_len", "s1", "crop_l")})
    it = 0
    while it < n_iters:
        order = rng.permutation(n)
        for b0 in range(0, n - bs + 1, bs):
            if it >= n_iters:
                break
            out["idx"][it] = order[b0:b0 + bs]
            win = (0 if eff_l == ts_l
                   else int(rng.integers(ts_l - eff_l + 1)))
            crop_l = int(rng.integers(2 ** (temporal_unit + 1), eff_l + 1))
            crop_left = int(rng.integers(eff_l - crop_l + 1))
            crop_right = crop_left + crop_l
            crop_eleft = int(rng.integers(crop_left + 1))
            crop_eright = int(rng.integers(crop_right, eff_l + 1))
            offsets = rng.integers(-crop_eleft, eff_l - crop_eright + 1,
                                   size=bs)
            out["w1_start"][it] = win + offsets + crop_eleft
            out["w1_len"][it] = crop_right - crop_eleft
            out["s1"][it] = (crop_right - crop_eleft) - crop_l
            out["w2_start"][it] = win + offsets + crop_left
            out["w2_len"][it] = crop_eright - crop_left
            out["crop_l"][it] = crop_l
            it += 1
    return out


def _window(rows: torch.Tensor, starts: torch.Tensor, length: int):
    """rows (B, T, D), per-row starts (B,) -> (B, length, D)."""
    pos = starts[:, None] + torch.arange(length, device=rows.device)
    return rows[torch.arange(rows.shape[0], device=rows.device)[:, None],
                pos]


def _fit_loop(net, optimizer, swa_params, swa_n0, data, geom, draw,
              temporal_unit):
    """Run ``len(geom['crop_l'])`` iterations: two encoder passes over the
    windows, the exact hierarchical loss on the overlap, AdamW, then the
    SWA mean. ``draw(it, which, shape)`` gives iteration ``it``'s mask
    (which 0, 2) and keep (1, 3) draws, leading-aligned to the window.
    Returns the per-iteration losses as one device tensor."""
    dev = data.device
    params = list(net.parameters())
    idx = torch.as_tensor(geom["idx"], dtype=torch.long, device=dev)
    w1s = torch.as_tensor(geom["w1_start"], dtype=torch.long, device=dev)
    w2s = torch.as_tensor(geom["w2_start"], dtype=torch.long, device=dev)
    losses = []
    for it in range(idx.shape[0]):
        rows = data[idx[it]]
        crop_l, s1 = int(geom["crop_l"][it]), int(geom["s1"][it])
        l1, l2 = int(geom["w1_len"][it]), int(geom["w2_len"][it])
        B, co = rows.shape[0], net.blocks[-1].conv2.out_channels
        o1 = net(_window(rows, w1s[it], l1), draw(it, 0, (B, l1)),
                 draw(it, 1, (B, l1, co)))
        o2 = net(_window(rows, w2s[it], l2), draw(it, 2, (B, l2)),
                 draw(it, 3, (B, l2, co)))
        loss = hierarchical_contrastive_loss(
            o1[:, s1:s1 + crop_l], o2[:, :crop_l],
            temporal_unit=temporal_unit)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            diff = torch._foreach_sub(params, swa_params)
            torch._foreach_div_(diff, float(swa_n0 + it + 1))
            torch._foreach_add_(swa_params, diff)
        losses.append(loss.detach())
    return torch.stack(losses)


def _centerize_vary_length_series(x: np.ndarray) -> np.ndarray:
    """Roll each row so its all-NaN padding splits across both ends
    (reference ts2vec.py:542-549)."""
    prefix = np.argmax(~np.isnan(x).all(axis=-1), axis=1)
    suffix = np.argmax(~np.isnan(x[:, ::-1]).all(axis=-1), axis=1)
    offset = (prefix + suffix) // 2 - prefix
    rows, cols = np.ogrid[:x.shape[0], :x.shape[1]]
    offset[offset < 0] += x.shape[1]
    return x[rows, cols - offset[:, np.newaxis]]


class TS2Vec:
    """The fit/encode model (reference TS2Vec :23-331) on ``device`` (None =
    CUDA). The encoder is initialised at construction from torch seed 0
    in a forked RNG whatever ``seed`` is (JAX inits from key 0); ``seed``
    drives the host draws and the mask and dropout draws."""

    def __init__(self, input_dims, output_dims=320, hidden_dims=64,
                 depth=10, device=None, lr=0.001, batch_size=16,
                 max_train_length=None, temporal_unit=0, seed=0):
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.net = TSEncoder(input_dims, output_dims, hidden_dims,
                                 depth, device="cpu")
        self.net.to(self.device)
        self.lr = lr
        self.batch_size = batch_size
        self.max_train_length = max_train_length
        self.temporal_unit = temporal_unit
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.optimizer = None
        self.swa = None          # the SWA encoder; None until fit or load
        # the reference snapshots the init weights into the average
        # (AveragedModel(...).update_parameters in __init__, :64-65), so
        # the SWA mean is mean(init, p1..pN): n starts at 1
        self.swa_n = 1
        self.n_iters = 0
        self.n_epochs = 0
        # the per-iteration losses of the last fit
        self.last_losses = np.zeros(0, np.float32)

    def _random_draw(self, it, which, shape):
        p = 0.5 if which in (0, 2) else 0.9
        return torch.rand(shape, generator=self.generator,
                          device=self.device) < p

    def fit(self, train_data: np.ndarray, n_epochs=None, n_iters=None,
            verbose=False, draws: Optional[Dict[str, np.ndarray]] = None):
        """Train on (N, T, D) ``train_data`` (NaN = missing). ``draws``
        injects the mask and dropout draws: arrays ``mask1``, ``mask2``
        (n_iters, B, T) and ``keep1``, ``keep2`` (n_iters, B, T,
        output_dims) over the full buffer, of which each window takes its
        leading positions (JAX's windows are left-aligned buffers).
        Returns the mean loss of each completed epoch."""
        if train_data.ndim != 3:
            raise ValueError(f"want (N, T, D) data, got {train_data.shape}")
        # the default n_iters comes from the RAW input size, before the
        # split or the all-NaN-row filter (reference :87-88)
        if n_iters is None and n_epochs is None:
            n_iters = 200 if train_data.size <= 100000 else 600
        if self.max_train_length is not None:
            sections = train_data.shape[1] // self.max_train_length
            if sections >= 2:
                splits = np.array_split(train_data, sections, axis=1)
                L = splits[0].shape[1]
                padded = [np.pad(s, ((0, 0), (0, L - s.shape[1]), (0, 0)),
                                 constant_values=np.nan) for s in splits]
                train_data = np.concatenate(padded, axis=0)
        missing = np.isnan(train_data).all(axis=-1).any(axis=0)
        if train_data.shape[1] and (missing[0] or missing[-1]):
            train_data = _centerize_vary_length_series(train_data)
        train_data = train_data[
            ~np.isnan(train_data).all(axis=2).all(axis=1)]

        n = train_data.shape[0]
        if n == 0:
            return []
        ts_l = train_data.shape[1]
        bs = min(self.batch_size, n)
        per_epoch = max((n - bs) // bs + 1, 1)
        # targets are cumulative across fit() calls (the reference's
        # persistent self.n_iters / self.n_epochs counters)
        if n_iters is not None:
            n_iters = n_iters - self.n_iters
        else:
            n_iters = (n_epochs - self.n_epochs) * per_epoch
        if n_iters <= 0:
            return []

        if self.swa is None:
            self.swa = copy.deepcopy(self.net).requires_grad_(False)
            self.optimizer = torch.optim.AdamW(
                self.net.parameters(), lr=self.lr, weight_decay=0.01,
                foreach=True)
        mtl = self.max_train_length
        eff_l = ts_l if mtl is None else min(ts_l, mtl)
        geom = _draw_windows(self.rng, n, bs, ts_l, eff_l,
                             self.temporal_unit, n_iters)
        if draws is None:
            draw = self._random_draw
        else:
            names = ("mask1", "keep1", "mask2", "keep2")
            staged = {k: torch.as_tensor(np.asarray(draws[k], bool),
                                         device=self.device) for k in names}

            def draw(it, which, shape):
                return staged[names[which]][it][:, :shape[1]]

        data = torch.as_tensor(np.asarray(train_data, np.float32),
                               device=self.device)
        self.net.train()
        with _exact_f32():
            losses = _fit_loop(self.net, self.optimizer,
                               list(self.swa.parameters()), self.swa_n,
                               data, geom, draw, self.temporal_unit)
        losses = self.last_losses = losses.cpu().numpy()
        self.swa_n += n_iters
        self.n_iters += n_iters

        # only completed epochs are logged (the reference breaks on
        # 'interrupted' before appending the partial epoch's mean, :160)
        loss_log = []
        for e0 in range(0, n_iters - per_epoch + 1, per_epoch):
            loss_log.append(float(losses[e0:e0 + per_epoch].mean()))
            if verbose:
                print(f"Epoch #{self.n_epochs}: loss={loss_log[-1]}")
            self.n_epochs += 1
        return loss_log

    @torch.no_grad()
    def encode(self, data: np.ndarray, encoding_window=None,
               batch_size=None) -> np.ndarray:
        """The SWA encoder's eval-mode output: (N, T, C), or (N, C), the
        max over time, for ``encoding_window='full_series'``."""
        if self.swa is None:
            raise RuntimeError("please train or load a net first")
        if data.ndim != 3:
            raise ValueError(f"want (N, T, D) data, got {data.shape}")
        bs = batch_size or self.batch_size
        self.swa.eval()
        outs = []
        with _exact_f32():
            for b0 in range(0, data.shape[0], bs):
                x = torch.as_tensor(np.asarray(data[b0:b0 + bs], np.float32),
                                    device=self.device)
                out = self.swa(x)
                if encoding_window == "full_series":
                    out = out.amax(dim=1)
                outs.append(out)
        return torch.cat(outs).cpu().numpy()

    def save(self, fn: str):
        """The SWA weights as a torch state_dict."""
        if self.swa is None:
            raise RuntimeError("please train or load a net first")
        torch.save({k: v.cpu() for k, v in self.swa.state_dict().items()},
                   fn)

    def load(self, fn: str):
        sd = torch.load(fn, map_location="cpu", weights_only=True)
        if self.swa is None:
            self.swa = copy.deepcopy(self.net).requires_grad_(False)
        self.swa.load_state_dict(sd)


def initialize_ts2vec(X_train: np.ndarray, device=None) -> TS2Vec:
    """Train the C-FID feature extractor on the eval data (reference
    :12-21: batch 8, lr 1e-3, output_dims 100, max_train_length 3000) on
    ``device`` (None = CUDA)."""
    model = TS2Vec(input_dims=X_train.shape[-1], device=device,
                   batch_size=8, lr=0.001, output_dims=100,
                   max_train_length=3000)
    model.fit(X_train, verbose=False)
    return model
