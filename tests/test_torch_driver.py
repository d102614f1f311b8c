"""The port's Slam driver: loss recovery, the EOF state restore, keyframe
eviction with the pose archive, and the bootstrap's reference-frame
chances. Scenarios and bounds are tests/test_pipeline.py's, run on the
port (CPU tensors, so the kernels' plain twins)."""

import numpy as np
import pytest
import torch

from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.slam.config import SlamConfig
from racing_slam_tpu_torch.slam.pipeline import Slam
from racing_slam_tpu_torch.utils.metrics import ate_rmse, camera_centers
from racing_slam_tpu_torch.utils.synthetic import make_sequence
from racing_slam_tpu_torch.utils.video import ArraySource

torch.set_num_threads(2)
STEP = np.array([0.10, 0.01, 0.16], np.float32)
BASE = dict(triangulate_points=True, bundle_adjust=True, optimize_pose=True, cull_points=True,
            max_keyframes=16, map_capacity=2048)


def _cam():
    return Camera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)


def _run(frames, cfg, batched):
    slam = Slam(_cam(), ArraySource(frames), cfg)
    assert slam.initialize()
    slam.run_batched(batch=4) if batched else slam.run()
    return slam


@pytest.mark.parametrize("batched", [False, True])
def test_tracking_lost_reinit(batched):
    """A hard cut to an unrelated scene is detected as a loss, the finished
    segment archived, and the engine re-bootstrapped on the new scene."""
    a = make_sequence(np.random.default_rng(5), n_frames=8, cam=_cam(), n_sprites=140,
                      step_t=STEP)
    b = make_sequence(np.random.default_rng(99), n_frames=8, cam=_cam(), n_sprites=140,
                      step_t=STEP)
    cfg = SlamConfig(**BASE, lost_check_interval=1)
    slam = _run(a.frames + b.frames, cfg, batched)
    assert slam.n_reinits >= 1
    assert len(slam.segments) == slam.n_reinits
    seg = slam.segments[0]
    assert seg["poses"].shape[0] >= 2
    assert int(slam.state.num_kf) >= 2
    assert seg["frame_indices"].min() < 8
    # Batches see the loss one batch late (the JAX driver's semantics).
    assert seg["frame_indices"].max() <= 8 + cfg.lost_patience + (4 if batched else 0)


def test_lost_at_eof_restores_state():
    """A loss declared too close to EOF for a re-bootstrap restores the
    archived world state instead of ending with an empty map."""
    a = make_sequence(np.random.default_rng(5), n_frames=10, cam=_cam(), n_sprites=140,
                      step_t=STEP)
    black = [np.zeros_like(a.frames[0]) for _ in range(4)]
    slam = _run(a.frames + black, SlamConfig(**BASE, lost_check_interval=1), False)
    assert slam.eof_on_reinit
    assert slam.n_reinits == 0 and len(slam.segments) == 0
    assert int(slam.state.num_kf) >= 2
    assert len(slam.points()) > 0


def test_keyframe_eviction_keeps_tracking():
    """At capacity the oldest keyframe is evicted into the archive; tracking
    stays alive and archive + live window cover every commit in order."""
    seq = make_sequence(np.random.default_rng(11), n_frames=26, cam=_cam(), n_sprites=160,
                        step_t=np.array([0.08, 0.01, 0.12], np.float32))
    cfg = SlamConfig(**{**BASE, "max_keyframes": 6}, reinit_on_lost=False)
    slam = _run(seq.frames, cfg, False)
    n_kf_committed = sum(i.is_keyframe for i in slam.infos) + 2
    assert n_kf_committed > 6
    kf_idx = slam.keyframe_indices()
    assert len(kf_idx) == 6 and list(kf_idx) == sorted(kf_idx)
    assert int(slam.infos[-1].n_matches_total) >= 30
    full_idx = slam.keyframe_indices(include_archived=True)
    assert len(full_idx) == n_kf_committed == len(set(full_idx.tolist()))
    assert int(slam.state.arch_count) == n_kf_committed - 6
    assert list(full_idx) == sorted(full_idx)
    gt = seq.poses[full_idx]
    ate = ate_rmse(slam.poses(include_archived=True), gt)
    length = np.linalg.norm(camera_centers(gt)[-1] - camera_centers(gt)[0])
    assert ate < 0.10 * max(length, 0.5)


def test_initialization_rejects_static_start():
    """Frames with no baseline do not bootstrap; the reference-frame chances
    move on until motion appears."""
    static = make_sequence(np.random.default_rng(3), n_frames=2, cam=_cam(), n_sprites=100,
                           step_t=np.zeros(3, np.float32), yaw_per_frame=0.0)
    moving = make_sequence(np.random.default_rng(3), n_frames=10, cam=_cam(), n_sprites=100,
                           step_t=np.array([0.12, 0.0, 0.15], np.float32))
    slam = Slam(_cam(), ArraySource([static.frames[0]] * 4 + moving.frames),
                SlamConfig(max_keyframes=8, map_capacity=1024))
    assert slam.initialize()
    assert slam.keyframe_indices()[1] >= 4


def test_reset_run_replays_the_same_run():
    """reset_run restores the driver and its random draws: a replay of the
    same stream gives the same keyframes, poses and map."""
    seq = make_sequence(np.random.default_rng(42), n_frames=10, cam=_cam(), n_sprites=140,
                        step_t=STEP)
    slam = _run(seq.frames, SlamConfig(**BASE), True)
    first = (slam.keyframe_indices(True), slam.poses(True), slam.points())
    slam.reset_run(ArraySource(seq.frames))
    assert slam.initialize()
    slam.run_batched(batch=4)
    np.testing.assert_array_equal(slam.keyframe_indices(True), first[0])
    np.testing.assert_array_equal(slam.poses(True), first[1])
    np.testing.assert_array_equal(slam.points(), first[2])
    assert slam.host_syncs["track"] == slam.frames_tracked == len(seq.frames) - 2


def test_synthetic_sequence_matches_jax():
    """The port's renderer draws the JAX package's frames and poses from the
    same seed (the same numpy code, so exactly)."""
    from racing_slam_tpu.ops.camera import Camera as JaxCamera
    from racing_slam_tpu.utils.synthetic import make_sequence as jax_make_sequence

    cam = Camera(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
    for step in (STEP, np.zeros(3, np.float32)):
        kw = dict(n_frames=3, n_sprites=40, step_t=step)
        got = make_sequence(np.random.default_rng(7), cam=cam, **kw)
        want = jax_make_sequence(np.random.default_rng(7), cam=JaxCamera(*cam), **kw)
        np.testing.assert_array_equal(got.poses, want.poses)
        for a, b in zip(got.frames, want.frames, strict=True):
            np.testing.assert_array_equal(a, b)
