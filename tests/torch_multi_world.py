"""The tiny multi-sequence world of tests/test_multi_seq.py:20-46 for the
port's tests: two 10-frame sequences at 320x240 and the small
configuration. Imports the port only, so the spawned workers can use it."""

import numpy as np

from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.slam.config import SlamConfig
from racing_slam_tpu_torch.utils.synthetic import make_sequence

CAM = Camera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)


def tiny_cfg(**kw) -> SlamConfig:
    return SlamConfig(**{**dict(
        triangulate_points=True, bundle_adjust=True, optimize_pose=True, cull_points=True,
        max_keyframes=4, map_capacity=256, max_observations=4, ba_iters=2, motion_ba_iters=2,
        ransac_hypotheses=64, reinit_on_lost=False), **kw})


def tiny_world(n: int = 2):
    seqs = [make_sequence(np.random.default_rng(42 + i), n_frames=10, cam=CAM, n_sprites=140,
                          step_t=np.array([0.10, 0.01, 0.16], np.float32)) for i in range(n)]
    return CAM, seqs
