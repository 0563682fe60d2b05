"""Length-Adaptive VAE (counterpart of t2ms_tpu/models/vae/lavae.py).

Encoder: Conv1d(k4,s2,p1) -> ReLU -> Conv1d(k4,s2,p1) -> ReLU
         -> Conv1d(k3,s1,p1) -> ResidualStack -> 1x1 Conv to embedding_dim
         -> linear-resize to ``latent_grid``
Decoder: linear-resize latent to length/4 -> Conv1d(k3,s1,p1)
         -> ResidualStack -> ConvT(k4,s2,p1) -> ReLU -> ConvT(k4,s2,p1)
         [-> exact-length resize when ``exact_length_output``]

Submodules carry the reference vqvae state_dict names (``encoder._conv_1``,
``encoder._residual_stack._layers.{i}._block.{1,3}``, ``_pre_vq_conv``,
``decoder._conv_trans_{1,2}``), so reference checkpoints load directly and
``tools/import_torch_ckpt.py`` reads a port state_dict.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.ops.conv1d import Conv1d, ConvTranspose1d
from t2ms_tpu_torch.ops.resize import linear_resize

__all__ = ["LAVAE", "lavae_loss", "smooth_l1_temporal_loss"]


class _Residual(nn.Module):
    def __init__(self, num_hiddens: int, num_residual_hiddens: int):
        super().__init__()
        self._block = nn.Sequential(
            nn.ReLU(),
            Conv1d(num_hiddens, num_residual_hiddens, 3, 1, 1,
                   use_bias=False),
            nn.ReLU(),
            Conv1d(num_residual_hiddens, num_hiddens, 1, 1, 0,
                   use_bias=False))

    def forward(self, x):
        # reference quirk (vqvae.py:11): the Sequential's leading
        # ReLU(inplace=True) mutates the skip operand, so the unit computes
        # relu(x) + block(relu(x))
        x = F.relu(x)
        return x + self._block(x)


class _ResidualStack(nn.Module):
    def __init__(self, num_hiddens, num_residual_layers,
                 num_residual_hiddens):
        super().__init__()
        self._layers = nn.ModuleList(
            [_Residual(num_hiddens, num_residual_hiddens)
             for _ in range(num_residual_layers)])

    def forward(self, x):
        for layer in self._layers:
            x = layer(x)
        return F.relu(x)


class _Encoder(nn.Module):
    def __init__(self, in_channels, num_hiddens, num_residual_layers,
                 num_residual_hiddens, embedding_dim, latent_grid):
        super().__init__()
        self.latent_grid = latent_grid
        self._conv_1 = Conv1d(in_channels, num_hiddens // 2, 4, 2, 1)
        self._conv_2 = Conv1d(num_hiddens // 2, num_hiddens, 4, 2, 1)
        self._conv_3 = Conv1d(num_hiddens, num_hiddens, 3, 1, 1)
        self._residual_stack = _ResidualStack(
            num_hiddens, num_residual_layers, num_residual_hiddens)
        self._pre_vq_conv = Conv1d(num_hiddens, embedding_dim, 1, 1, 0)

    def forward(self, x):
        if x.ndim == 2:                 # univariate (B, T) -> (B, 1, T)
            x = x[:, None, :]
        h = F.relu(self._conv_1(x))
        h = F.relu(self._conv_2(h))
        h = self._residual_stack(self._conv_3(h))
        before = self._pre_vq_conv(h)
        return linear_resize(before, self.latent_grid), before


class _Decoder(nn.Module):
    def __init__(self, out_channels, num_hiddens, num_residual_layers,
                 num_residual_hiddens, embedding_dim, exact_length_output):
        super().__init__()
        self.out_channels = out_channels
        self.exact_length_output = exact_length_output
        self._conv_1 = Conv1d(embedding_dim, num_hiddens, 3, 1, 1)
        self._residual_stack = _ResidualStack(
            num_hiddens, num_residual_layers, num_residual_hiddens)
        self._conv_trans_1 = ConvTranspose1d(num_hiddens, num_hiddens // 2,
                                             4, 2, 1)
        self._conv_trans_2 = ConvTranspose1d(num_hiddens // 2, out_channels,
                                             4, 2, 1)

    def forward(self, z, length: int):
        after = linear_resize(z, int(length / 4))
        h = self._residual_stack(self._conv_1(after))
        h = F.relu(self._conv_trans_1(h))
        x = self._conv_trans_2(h)
        if self.exact_length_output:
            x = linear_resize(x, length)       # myvqvae.py:85
        if self.out_channels == 1:
            x = x.squeeze(1)                   # vqvae.py:105
        return x, after


class LAVAE(nn.Module):
    """Unified LA-VAE. ``in_channels=1, latent_grid=30,
    exact_length_output=False`` is the T2S vqvae; ``in_channels=input_dim,
    latent_grid=flow_dim, exact_length_output=True`` the T2MS myvqvae.
    Parameters are created on ``device`` (None = CUDA)."""

    def __init__(self, in_channels: int = 1, num_hiddens: int = 128,
                 num_residual_layers: int = 2,
                 num_residual_hiddens: int = 256, embedding_dim: int = 64,
                 latent_grid: int = 30, exact_length_output: bool = False,
                 device=None):
        super().__init__()
        self.encoder = _Encoder(in_channels, num_hiddens,
                                num_residual_layers, num_residual_hiddens,
                                embedding_dim, latent_grid)
        self.decoder = _Decoder(in_channels, num_hiddens,
                                num_residual_layers, num_residual_hiddens,
                                embedding_dim, exact_length_output)
        self.to(resolve_device(device))

    def encode(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(x)

    def decode(self, z, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.decoder(z, length)

    def forward(self, x):
        z, before = self.encoder(x)
        recon, after = self.decoder(z, x.shape[-1])
        return recon, z, before, after


def lavae_loss(model: LAVAE, batch: torch.Tensor):
    """loss = recon MSE + cross MSE(before, after) (vqvae.py:118-135).
    Returns (loss, (recon_error, recon, z))."""
    recon, z, before, after = model(batch)
    target = batch
    if target.ndim == recon.ndim + 1 and target.shape[1] == 1:
        target = target[:, 0]
    elif target.ndim + 1 == recon.ndim:
        target = target[:, None, :]
    if target.shape != recon.shape:
        raise ValueError(f"batch {tuple(batch.shape)} does not reconcile "
                         f"with recon {tuple(recon.shape)}")
    recon_error = torch.mean(torch.square(recon - target))
    cross = torch.mean(torch.square(before - after))
    return recon_error + cross, (recon_error, recon, z)


def smooth_l1_temporal_loss(x, y, lambda_smooth: float = 0.1):
    """myvqvae.custom_loss (myvqvae.py:144-156): smooth-L1 plus a temporal
    smoothness term on first differences along the last axis. Unused by
    the reference trainer but part of the public surface."""
    def smooth_l1(a, b):
        d = torch.abs(a - b)
        return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))
    xd = x[..., 1:] - x[..., :-1]
    yd = y[..., 1:] - y[..., :-1]
    return smooth_l1(x, y) + lambda_smooth * smooth_l1(xd, yd)
