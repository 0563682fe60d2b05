"""The infer CLI's figures (counterpart of the two functions of
t2ms_tpu/visualize/diagnostics.py that ``cli/infer.py`` calls): the
ground-truth-vs-generated line plots (reference infer.py:157-176) and the
diffusion GIF (myinfer.py:48-65). matplotlib and imageio are imported
inside the functions: the port's path does not need them, and the infer
CLI skips the figures where matplotlib is absent.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["plot_generation_figs", "save_diffusion_gif"]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


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
