"""Benchpress skeleton animators: rear-view arm kinematics and top-view
pose synthesis (counterpart of t2ms_tpu/visualize/benchpress.py).

Reference: visualize/benchpress.py — RearV_BenchpressAnimator (:7-166)
reconstructs arm segments from joint-angle series via planar forward
kinematics; TopV_BenchpressAnimator (:169-351) synthesizes an 8-joint
top-down pose from torso-arm angles and wrist distances. Both render
animations from a feature dict (the generated sample's per-feature series).

Re-design: all per-frame geometry is computed VECTORIZED over the whole
clip up front (numpy), then frames are rasterized with matplotlib and
written as GIF/MP4 via imageio (no ffmpeg writer dependency; imageio's
pillow backend handles .gif, ffmpeg is used for .mp4 when available).
matplotlib and imageio are imported inside ``_save_animation``: the pose
math needs numpy only.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

__all__ = ["RearViewBenchpressAnimator", "TopViewBenchpressAnimator",
           # reference-compatible aliases (myinfer.py:17 import names)
           "RearV_BenchpressAnimator", "TopV_BenchpressAnimator"]


def _norm(arr, a, b, c, d):
    arr = np.asarray(arr, float)
    return (arr - a) * (d - c) / (b - a) + c


def _save_animation(render_frame, n_frames: int, output_file: str,
                    fps: int = 30, figsize=(7, 7)) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    try:
        import imageio.v2 as imageio
    except ImportError:
        import imageio
    images = []
    for i in range(n_frames):
        fig, ax = plt.subplots(figsize=figsize)
        render_frame(ax, i)
        fig.canvas.draw()
        images.append(np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy())
        plt.close(fig)
    d = os.path.dirname(output_file)
    if d:
        os.makedirs(d, exist_ok=True)
    if output_file.endswith(".gif"):
        imageio.mimsave(output_file, images, duration=1.0 / fps)
    else:
        imageio.mimsave(output_file, images, fps=fps)
    return os.path.abspath(output_file)


class RearViewBenchpressAnimator:
    """Rear-view arms: shoulder origin on the clavicle line, upper-arm
    length foreshortened by |sin(torso-arm angle)| (reference :63-87)."""

    def __init__(self, config: Dict[str, Sequence[float]]):
        self.ls_ang = np.asarray(config["left_shoulder"], float)
        self.le_ang = np.asarray(config["left_elbow"], float)
        self.rs_ang = np.asarray(config["right_shoulder"], float)
        self.re_ang = np.asarray(config["right_elbow"], float)
        self.ls_y = _norm(config["left_shoulder_y"], 0.0, 640.0, -3.0, 1.0)
        self.rs_y = _norm(config["right_shoulder_y"], 0.0, 640.0, -3.0, 1.0)
        self.th_l = np.asarray(config["left_torso-arm"], float)
        self.th_r = np.asarray(config["right_torso-arm"], float)
        self.L_upper = float(config.get("L_upper", 1.0))
        self.L_fore = float(config.get("L_fore", 1.0))
        self.fps = int(config.get("fps", 30))
        self.n = len(self.ls_ang)
        self._precompute()

    def _arm(self, sh_deg, el_deg, torso_deg, origin_x, origin_y, side):
        L_rear = self.L_upper * np.abs(np.sin(np.deg2rad(torso_deg)))
        bend = np.pi - np.deg2rad(el_deg)
        if side == "left":
            upper_dir = -np.deg2rad(sh_deg)
            fore_dir = upper_dir + bend
        else:
            upper_dir = np.pi + np.deg2rad(sh_deg)
            fore_dir = upper_dir - bend
        sx = np.full_like(origin_y, origin_x)
        ex = sx + L_rear * np.cos(upper_dir)
        ey = origin_y + L_rear * np.sin(upper_dir)
        wx = ex + self.L_fore * np.cos(fore_dir)
        wy = ey + self.L_fore * np.sin(fore_dir)
        return np.stack([sx, origin_y], -1), np.stack([ex, ey], -1), \
            np.stack([wx, wy], -1)

    def _precompute(self):
        self.l_sh, self.l_el, self.l_wr = self._arm(
            self.ls_ang, self.le_ang, self.th_l, -1.0, self.ls_y, "left")
        self.r_sh, self.r_el, self.r_wr = self._arm(
            self.rs_ang, self.re_ang, self.th_r, 1.0, self.rs_y, "right")

    def _render(self, ax, i):
        ax.set_aspect("equal")
        ax.set_xlim(-3, 3)
        ax.set_ylim(-3, 1)
        ax.invert_yaxis()
        ax.plot([-1, 1], [self.ls_y[i], self.rs_y[i]], "-", color="black",
                lw=2)
        for sh, el, wr in ((self.l_sh, self.l_el, self.l_wr),
                           (self.r_sh, self.r_el, self.r_wr)):
            ax.plot([sh[i, 0], el[i, 0]], [sh[i, 1], el[i, 1]], "o-", lw=3,
                    color="tab:blue")
            ax.plot([el[i, 0], wr[i, 0]], [el[i, 1], wr[i, 1]], "o-", lw=3,
                    color="tab:orange")
        # barbell: wrist-to-wrist segment extrapolated by 0.15 each side
        seg = self.l_wr[i] - self.r_wr[i]
        nrm = np.hypot(*seg)
        u = seg / nrm if nrm > 1e-9 else np.array([1.0, 0.0])
        p0, p1 = self.r_wr[i] - 0.15 * u, self.l_wr[i] + 0.15 * u
        ax.plot([p0[0], p1[0]], [p0[1], p1[1]], "-", color="tab:gray", lw=3)
        ax.set_title(f"Frame {i}")

    def animate(self, output_file: str) -> str:
        path = _save_animation(self._render, self.n, output_file, self.fps)
        print(f"animation written: {path}")
        return path


class TopViewBenchpressAnimator:
    """Top-down 8-joint pose: shoulders/hips box, elbows from torso-arm
    rotation with |cos(shoulder angle)| foreshortening, wrists dropped by
    the wrist-shoulder distance features (reference :222-253)."""

    CONNECTIONS = [(0, 1), (0, 4), (4, 6), (1, 5), (5, 7), (0, 2), (1, 3),
                   (2, 3)]

    def __init__(self, config: Dict[str, Sequence[float]]):
        self.d_l = _norm(config["left_dist"], 0.0, 480.0, 0.0, 4.0)
        self.d_r = _norm(config["right_dist"], 0.0, 480.0, 0.0, 4.0)
        self.th_l = np.asarray(config["left_torso-arm"], float)
        self.th_r = np.asarray(config["right_torso-arm"], float)
        self.ls_ang = np.asarray(config["left_shoulder"], float)
        self.rs_ang = np.asarray(config["right_shoulder"], float)
        self.fps = int(config.get("fps", 30))
        self.n = len(self.d_l)
        self._precompute()

    def _precompute(self):
        cx, cy = 0.0, 1.0
        sw, hw, tl, ua = 1.0, 0.8, 2.0, 0.8
        n = self.n
        ones = np.ones(n)
        p0 = np.stack([ones * (cx - sw / 2), ones * cy], -1)   # right shldr
        p1 = np.stack([ones * (cx + sw / 2), ones * cy], -1)   # left shldr
        p2 = np.stack([ones * (cx - hw / 2), ones * (cy - tl)], -1)
        p3 = np.stack([ones * (cx + hw / 2), ones * (cy - tl)], -1)
        L_r = ua * np.abs(np.cos(np.deg2rad(self.rs_ang)))
        L_l = ua * np.abs(np.cos(np.deg2rad(self.ls_ang)))
        trunk = np.array([0.0, -1.0])                 # perp of shoulder line
        ang_r = -np.deg2rad(self.th_r)
        ang_l = np.deg2rad(self.th_l)

        def rot(v, a):
            c, s = np.cos(a), np.sin(a)
            return np.stack([v[0] * c - v[1] * s, v[0] * s + v[1] * c], -1)

        dir_r = rot(trunk, ang_r)
        dir_l = rot(trunk, ang_l)
        p4 = p0 + dir_r * L_r[:, None]                # right elbow
        p5 = p1 + dir_l * L_l[:, None]                # left elbow
        p6 = np.stack([p4[:, 0], p0[:, 1] - self.d_r], -1)   # right wrist
        p7 = np.stack([p5[:, 0], p1[:, 1] - self.d_l], -1)   # left wrist
        self.pts = np.stack([p0, p1, p2, p3, p4, p5, p6, p7], axis=1)

    def _render(self, ax, i):
        ax.set_xlim(-2, 2)
        ax.set_ylim(-2, 2)
        ax.set_aspect("equal", adjustable="box")
        ax.grid(True)
        pts = self.pts[i]
        for a, b in self.CONNECTIONS:
            ax.plot([pts[a, 0], pts[b, 0]], [pts[a, 1], pts[b, 1]],
                    color="orange", lw=2)
        ax.scatter(pts[:, 0], pts[:, 1], color="blue", s=60)
        # wrist verticals + shoulder midline + barbell bridge
        for w, s in ((6, 0), (7, 1)):
            ax.plot([pts[w, 0], pts[w, 0]],
                    [min(pts[w, 1], pts[s, 1]), max(pts[w, 1], pts[s, 1])],
                    "--", lw=2)
        y_mid = 0.5 * (pts[0, 1] + pts[1, 1])
        ax.plot([-2, 2], [y_mid, y_mid], "--", color="gray", lw=1.5)
        seg = pts[7] - pts[6]
        nrm = np.hypot(*seg)
        u = seg / nrm if nrm > 1e-9 else np.array([1.0, 0.0])
        p0, p1 = pts[6] - 0.15 * u, pts[7] + 0.15 * u
        ax.plot([p0[0], p1[0]], [p0[1], p1[1]], "-", color="tab:gray", lw=3)
        ax.set_title(f"Frame {i + 1}")

    def animate(self, output_file: str) -> str:
        # required (like RearView's): a None default only surfaced as an
        # AttributeError AFTER rendering every frame
        path = _save_animation(self._render, self.n, output_file, self.fps)
        print(f"animation written: {path}")
        return path


# Aliases matching the reference class names for drop-in imports
RearV_BenchpressAnimator = RearViewBenchpressAnimator
TopV_BenchpressAnimator = TopViewBenchpressAnimator
