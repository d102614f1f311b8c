"""Trajectory and map dumps (port of racing_slam_tpu/utils/viz.py), all on
the host in numpy:

- save_trajectory_plot: a 3D figure of camera frusta and the point cloud;
- save_overlay: a frame with its keypoints and the projections of the map
  points they matched;
- export_ply: the point cloud and camera centres as ASCII PLY;
- save_trajectory_tum: the trajectory in TUM format (timestamp tx ty tz qx
  qy qz qw, camera to world).

matplotlib (the first two) and scipy (the last) are imported when called.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _centers_and_rots(poses: np.ndarray):
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t), R


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_trajectory_plot(path: str | Path, poses: np.ndarray, points: np.ndarray | None = None,
                         colors: np.ndarray | None = None, frustum_scale: float = 0.2) -> None:
    plt = _pyplot()
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    centers, R = _centers_and_rots(poses)
    ax.plot(centers[:, 0], centers[:, 1], centers[:, 2], "b-", lw=1)
    # Each camera as four rays to its frustum's corners.
    for c, Ri in zip(centers, R):
        fwd = Ri.T @ np.array([0, 0, 1.0]) * frustum_scale
        right = Ri.T @ np.array([1.0, 0, 0]) * frustum_scale * 0.6
        up = Ri.T @ np.array([0, 1.0, 0]) * frustum_scale * 0.4
        for corner in (fwd + right + up, fwd - right + up, fwd + right - up, fwd - right - up):
            ax.plot(*np.stack([c, c + corner]).T, "g-", lw=0.4)
    if points is not None and len(points):
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=0.5,
                   c=colors if colors is not None else "k", alpha=0.6)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.view_init(elev=-60, azim=-90)  # y-down camera convention
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_overlay(path: str | Path, image: np.ndarray, keypoints: np.ndarray | None = None,
                 projections: np.ndarray | None = None,
                 matches_mask: np.ndarray | None = None) -> None:
    """The frame with keypoints (green) and a red line from each matched
    keypoint to its map point's projection."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(image, cmap="gray", vmin=0, vmax=1)
    if keypoints is not None and len(keypoints):
        ax.plot(keypoints[:, 0], keypoints[:, 1], "g.", ms=2)
    if projections is not None and matches_mask is not None and keypoints is not None:
        for k in np.where(matches_mask)[0]:
            ax.plot([keypoints[k, 0], projections[k, 0]], [keypoints[k, 1], projections[k, 1]],
                    "r-", lw=0.5)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def export_ply(path: str | Path, points: np.ndarray, colors: np.ndarray | None = None,
               poses: np.ndarray | None = None) -> None:
    """ASCII PLY of the map (gray intensity colours) and camera centres (green)."""
    if colors is None:
        colors = np.full(len(points), 0.7)
    rows = []
    for p, c in zip(points, colors):
        g = int(np.clip(c, 0, 1) * 255)
        rows.append(f"{p[0]} {p[1]} {p[2]} {g} {g} {g}")
    if poses is not None:
        for c in _centers_and_rots(poses)[0]:
            rows.append(f"{c[0]} {c[1]} {c[2]} 0 255 0")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(rows)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n")
        f.write("\n".join(rows) + "\n")


def save_trajectory_tum(path: str | Path, poses: np.ndarray, stamps=None) -> None:
    """TUM trajectory (camera to world), one line a pose."""
    from scipy.spatial.transform import Rotation

    centers, R = _centers_and_rots(poses)
    if stamps is None:
        stamps = np.arange(len(poses), dtype=np.float64)
    with open(path, "w") as f:
        for s, c, Ri in zip(stamps, centers, R):
            q = Rotation.from_matrix(Ri.T).as_quat()  # x y z w
            f.write(f"{s:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
