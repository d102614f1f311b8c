"""Trajectory evaluation: Sim(3) alignment, ATE and rotation error (port of
racing_slam_tpu/utils/metrics.py; numpy on the host)."""

from __future__ import annotations

import numpy as np


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """[N, 4, 4] world->camera poses -> [N, 3] camera centers (-R^T t)."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def umeyama_sim3(src: np.ndarray, dst: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity s, R, t minimising ||dst - (s R src + t)||
    (Umeyama 1991). src, dst: [N, 3]."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    var_s = (xs**2).sum() / len(src)
    s = np.trace(np.diag(S) @ D) / (var_s + 1e-12)
    return float(s), R, mu_d - s * R @ mu_s


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> float:
    """RMSE of camera-center error after optional Sim(3) alignment.
    est_poses, gt_poses: [N, 4, 4] world->camera, same frame order."""
    c_est = camera_centers(est_poses)
    c_gt = camera_centers(gt_poses)
    if align:
        s, R, t = umeyama_sim3(c_est, c_gt)
        c_est = (s * (R @ c_est.T)).T + t
    err = np.linalg.norm(c_est - c_gt, axis=-1)
    return float(np.sqrt((err**2).mean()))


def rotation_errors_deg(est_poses: np.ndarray, gt_poses: np.ndarray) -> np.ndarray:
    """Per-frame rotation error in degrees, [N]: each rotation taken relative
    to its sequence's first frame (removing the global gauge rotation), then
    the angle of est_i gt_i^T. est_poses, gt_poses: [N, 4, 4] world->camera."""
    R_est = est_poses[:, :3, :3] @ est_poses[0, :3, :3].T
    R_gt = gt_poses[:, :3, :3] @ gt_poses[0, :3, :3].T
    dR = R_est @ np.transpose(R_gt, (0, 2, 1))
    c = np.clip((np.trace(dR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(c))
