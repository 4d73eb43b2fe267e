"""Debug visualization (counterpart of jrr_tpu/utils/viz.py): the
reference's human-in-the-loop checks (scripts/optimize.py:28-74 `viz`,
scripts/utils.py:148-179 `render_batch`, scripts/create_smpl_gt.py:599-634)
as PNG files through headless matplotlib (Agg).

matplotlib is imported when a figure is drawn, not with the module. Arrays
may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_silhouette_comparison(
    render,  # (B, S, S) soft silhouette
    mask,  # (B, S, S) target
    out_dir: str,
    joints_2d=None,  # (B, J, 2)
    name: str = "silhouette",
    render_threshold: float = 0.5,
    mask_threshold: float = 0.8,
) -> None:
    """Render, mask and their symmetric difference, both binarized, with the
    2D joints over the render (reference: scripts/optimize.py:35-48)."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    r = (_np(render) > render_threshold).astype(np.float32)
    m = (_np(mask) > mask_threshold).astype(np.float32)
    diff = np.abs(r - m)
    j2d = None if joints_2d is None else _np(joints_2d)
    for i in range(r.shape[0]):
        fig, axes = plt.subplots(1, 3, figsize=(9, 3))
        for ax, img, title in zip(axes, (r[i], m[i], diff[i]), ("render", "mask", "xor")):
            ax.imshow(img, cmap="gray")
            ax.set_title(title)
            ax.axis("off")
        if j2d is not None:
            axes[0].scatter(j2d[i, :, 0], j2d[i, :, 1], s=8, c="g")
        fig.savefig(os.path.join(out_dir, f"{i:03d}_{name}.png"), dpi=150)
        plt.close(fig)


def save_joints_overlay(
    image,  # (B, 3, H, W) in [0, 1]
    joint_sets: Sequence,  # list of (B, J, 2)
    out_dir: str,
    name: str = "joints",
    colors: Sequence[str] = ("r", "g", "b"),
) -> None:
    """2D joints over crops (reference: scripts/utils.py:148-179)."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    imgs = np.transpose(_np(image), (0, 2, 3, 1))
    sets = [_np(js) for js in joint_sets]
    for i in range(imgs.shape[0]):
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(np.clip(imgs[i], 0, 1))
        for js, c in zip(sets, colors):
            ax.scatter(js[i, :, 0], js[i, :, 1], s=8, c=c)
        ax.axis("off")
        fig.savefig(os.path.join(out_dir, f"{i:03d}_{name}.png"), dpi=150)
        plt.close(fig)


def save_pointcloud(points, path: str, gt_points=None) -> None:
    """3D scatter (reference: scripts/create_smpl_gt.py:599-634)."""
    plt = _plt()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    p = _np(points)
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=2, alpha=0.5)
    if gt_points is not None:
        g = _np(gt_points)
        ax.scatter(g[:, 0], g[:, 1], g[:, 2], s=20, c="r", marker="x")
    fig.savefig(path, dpi=150)
    plt.close(fig)
