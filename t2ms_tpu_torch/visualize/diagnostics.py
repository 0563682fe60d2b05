"""The CLIs' figures (counterpart of the functions of
t2ms_tpu/visualize/diagnostics.py that ``cli/pretrain_vae.py`` and
``cli/infer.py`` call): reconstruction comparisons and the PCA/t-SNE
scatter (reference pretrained_lavae_unified.py:25-52,
pretrained_mylavae.py:85-130), the ground-truth-vs-generated line plots
(infer.py:157-176), the motion track's side-by-side panels
(myinfer.py:67-100) and the diffusion GIF (myinfer.py:48-65). matplotlib,
sklearn and imageio are imported inside the functions: the port's paths
do not need them, and the CLIs skip the figures where they are absent.
"""

from __future__ import annotations

import importlib.util
import os
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["plot_comparison", "plot_pca_tsne", "plot_generation_figs",
           "plot_side_by_side_comparison", "save_diffusion_gif", "skipped"]


def skipped(what: str, *packages: str) -> bool:
    """Whether ``what`` must be skipped for want of ``packages``; if so,
    prints one line naming the missing ones."""
    missing = [m for m in packages if importlib.util.find_spec(m) is None]
    if missing:
        print(f"{what} skipped: {', '.join(missing)} not installed")
    return bool(missing)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_comparison(real: Sequence[np.ndarray],
                    reconstructed: Sequence[np.ndarray],
                    save_path: str) -> None:
    """Real-vs-reconstructed panels, comparison_{i}.png."""
    plt = _plt()
    os.makedirs(save_path, exist_ok=True)
    for i in range(len(real)):
        fig, axs = plt.subplots(1, 2, figsize=(10, 5))
        axs[0].plot(np.asarray(real[i]).T if np.ndim(real[i]) > 1
                    else real[i], label="Real")
        axs[0].set_title(f"Real Sample {i}")
        axs[1].plot(np.asarray(reconstructed[i]).T
                    if np.ndim(reconstructed[i]) > 1 else reconstructed[i],
                    label="Reconstructed")
        axs[1].set_title(f"Reconstructed Sample {i}")
        plt.savefig(f"{save_path}/comparison_{i}.png")
        plt.close(fig)


def _flatten_and_pad(samples: Sequence[np.ndarray]) -> np.ndarray:
    """Ravel each sample and zero-pad the rows to the longest: (n, L)."""
    flat = [np.asarray(s).reshape(-1) for s in samples]
    L = max(len(f) for f in flat)
    return np.stack([np.pad(f, (0, L - len(f))) for f in flat])


def plot_pca_tsne(real_samples, reconstructed_samples, save_path: str) -> str:
    """PCA + t-SNE scatter of real vs reconstructed, pca_tsne.png (the
    reference's perplexity clamp; t-SNE needs at least 4 points)."""
    from sklearn.decomposition import PCA
    from sklearn.manifold import TSNE
    plt = _plt()

    real = _flatten_and_pad(real_samples)
    reco = _flatten_and_pad(reconstructed_samples)
    L = max(real.shape[1], reco.shape[1])
    real = np.pad(real, ((0, 0), (0, L - real.shape[1])))
    reco = np.pad(reco, ((0, 0), (0, L - reco.shape[1])))
    combined = np.vstack([real, reco])
    labels = np.array([0] * len(real) + [1] * len(reco))

    n_comp = min(2, combined.shape[0], combined.shape[1])
    pca = PCA(n_components=n_comp).fit_transform(combined)
    if pca.shape[1] < 2:
        pca = np.pad(pca, ((0, 0), (0, 2 - pca.shape[1])))
    if combined.shape[0] >= 4:
        perplexity = min(combined.shape[0] - 1, 30)
        tsne = TSNE(n_components=2, perplexity=perplexity, init="pca",
                    learning_rate="auto").fit_transform(combined)
    else:
        tsne = pca
    fig, axs = plt.subplots(1, 2, figsize=(12, 6))
    for ax, emb, title in ((axs[0], pca, "PCA"), (axs[1], tsne, "t-SNE")):
        ax.scatter(emb[labels == 0, 0], emb[labels == 0, 1], s=12,
                   label="Real")
        ax.scatter(emb[labels == 1, 0], emb[labels == 1, 1], s=12,
                   label="Reconstructed")
        ax.set_title(title)
        ax.legend()
    os.makedirs(save_path, exist_ok=True)
    out = f"{save_path}/pca_tsne.png"
    plt.savefig(out)
    plt.close(fig)
    return out


def plot_side_by_side_comparison(x_1: Sequence[np.ndarray],
                                 x_t: Sequence[np.ndarray],
                                 mse_list: Sequence[float],
                                 subjects_list: Sequence,
                                 save_path: str,
                                 feature_names: Optional[List[str]] = None
                                 ) -> None:
    """Ground-truth vs generated multivariate panels
    (reference myinfer.py:67-100)."""
    plt = _plt()
    os.makedirs(save_path, exist_ok=True)
    for i in range(len(x_1)):
        fig = plt.figure(figsize=(12, 6))
        fig.suptitle(f"{subjects_list[i]} {mse_list[i]:.4f}", fontsize=10)
        ax1 = plt.subplot(1, 2, 1)
        ax2 = plt.subplot(1, 2, 2)
        for j in range(len(x_1[i])):
            name = (feature_names[j] if feature_names
                    and j < len(feature_names) else f"f{j}")
            ax1.plot(np.asarray(x_1[i][j]), label=name)
            ax2.plot(np.asarray(x_t[i][j]), label=name)
        ax1.set_title("Ground Truth")
        ax2.set_title("Generated")
        ax1.legend(fontsize=6)
        ax2.legend(fontsize=6)
        plt.tight_layout()
        plt.savefig(os.path.join(save_path, f"sample_{i}.jpg"))
        plt.close(fig)


def plot_generation_figs(x_1: np.ndarray, x_t: np.ndarray, save_path: str,
                         n: int = 10) -> None:
    """Per-sample GT-vs-generated line plots, fig_{i}.jpg."""
    plt = _plt()
    os.makedirs(save_path, exist_ok=True)
    for i in range(min(n, len(x_1))):
        plt.clf()
        plt.plot(np.asarray(x_1[i]).squeeze(), label="ground truth")
        plt.plot(np.asarray(x_t[i]).squeeze(), label="generated")
        plt.legend()
        plt.savefig(os.path.join(save_path, f"fig_{i}.jpg"))
    plt.close("all")


def save_diffusion_gif(frames: Sequence[np.ndarray], save_path: str,
                       filename: str = "diffusion.gif",
                       step_stride: int = 100) -> Optional[str]:
    """Render the denoising trajectory to a GIF; frames may be 1-D series
    or (n_f, T). Without imageio it prints one line and writes nothing."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        try:
            import imageio
        except ImportError:
            print("imageio unavailable; skipping diffusion GIF")
            return None
    plt = _plt()
    os.makedirs(save_path, exist_ok=True)
    images = []
    for i, frame in enumerate(frames):
        fig, ax = plt.subplots()
        frame = np.asarray(frame)
        if frame.ndim == 1:
            ax.plot(frame)
        else:
            for row in frame:
                ax.plot(row)
        ax.set_title(f"Diffusion Step {step_stride * i}")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        images.append(buf.copy())
        plt.close(fig)
    gif_path = os.path.join(save_path, filename)
    imageio.mimsave(gif_path, images, duration=0.5)
    print(f"GIF saved to {gif_path}")
    return gif_path
