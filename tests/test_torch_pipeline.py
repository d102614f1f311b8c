"""The port's pipeline against the JAX package's, on tests/test_pipeline.py's
synthetic sequence (320x240, 16 frames).

(a) One step from the same converted state (constant-velocity prediction,
    so no random draws): matches agree for >= 97 % of the keypoints (a
    near-tie in a guided match may flip), the pose to 1e-4 rad / 1e-3
    units (two motion-BA solves over float32 sums in another order), the
    keyframe decision exactly, the inlier count within 2 %. One keyframe
    commit from identical inputs: the same points created, culled and kept
    for >= 97 % of the slots, the commit BA's pose to 1e-4 / 1e-3.
(b) The slice as a whole: Slam.initialize() + run_batched() tracks with
    ATE < 8 % of the trajectory length and >= 4 keyframes, the bound of
    tests/test_pipeline.py:58-61.
(c) The scale path and the headline configuration: a forced commit with
    the window BA (local_ba_window=4) against the JAX package's, and a run
    with window BA, periodic refinement and the banded matcher within (b)'s
    bound.
(d) Every configuration value of the JAX package but its XLA/Pallas
    backend switches builds a `Slam`, and Slam without a card raises unless
    given device="cpu".
(e) The essential-matrix and adaptive pose predictions: one step of each
    from (a)'s state against the JAX package's, with the RANSAC uniforms
    JAX draws from its key passed to the port, at (a)'s tolerances. Shared
    uniforms give the same 8-point samples, but each sample's E is float32
    noise in both packages (as far from a float64 solve on either side),
    so the raw predictions differ; the guided match and motion BA after
    them converge to the same pose. An adaptive run tracks (b)'s sequence.
(f) The obs-descriptor cache equals the full regather, and the compacted
    cull the full sweep, on the port's twins (tests/test_pipeline.py's
    checks of the same invariants).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_slam_tpu.slam import pipeline as jp
from racing_slam_tpu.slam.config import SlamConfig as JaxSlamConfig
from racing_slam_tpu.utils.video import ArraySource as JaxArraySource
from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.slam import pipeline as tp
from racing_slam_tpu_torch.slam.config import SlamConfig
from racing_slam_tpu_torch.slam.frontend import ClassicalFrontend
from racing_slam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from racing_slam_tpu_torch.utils.metrics import ate_rmse, camera_centers
from racing_slam_tpu_torch.utils.synthetic import make_sequence
from racing_slam_tpu_torch.utils.video import ArraySource

torch.set_num_threads(2)

CFG = SlamConfig(
    triangulate_points=True, bundle_adjust=True, optimize_pose=True, cull_points=True,
    max_keyframes=16, map_capacity=2048, pose_prediction="constant_velocity",
    reproj_monitor_every=0, match_radius_px=28.0, keyframe_match_ratio=0.8,
)
JAX_CFG = JaxSlamConfig(**dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def seq():
    cam = Camera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)
    return make_sequence(np.random.default_rng(42), n_frames=16, cam=cam, n_sprites=140,
                         step_t=np.array([0.10, 0.01, 0.16], np.float32))


def _u8(f):
    return np.clip(f * 255.0, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX Slam bootstrapped and stepped over a few frames."""
    from racing_slam_tpu.ops.camera import Camera as JaxCamera

    jcam = JaxCamera(*seq.cam)
    slam = jp.Slam(jcam, JaxArraySource(seq.frames), JAX_CFG)
    assert slam.initialize()
    slam.run(3)
    return jcam, slam


def test_one_step_matches_jax(seq, jax_run):
    jcam, slam = jax_run
    st = slam.state
    i = int(st.frame_count)
    img = _u8(seq.frames[i])
    jst, jinfo = slam._step(st, jnp.asarray(img), jax.random.PRNGKey(0), None)
    tst, tinfo = tp.slam_step(state_from_numpy(jax.tree.map(np.asarray, st), device="cpu"),
                              torch.from_numpy(img), None, cam=Camera(*seq.cam), cfg=CFG,
                              frontend=ClassicalFrontend())
    jm, tm = np.asarray(jst.last_matches), tst.last_matches.numpy()
    assert (jm >= 0).sum() > 50
    assert (jm == tm).mean() >= 0.97
    np.testing.assert_allclose(tst.last_rvec.numpy(), np.asarray(jst.last_rvec), atol=1e-4)
    np.testing.assert_allclose(tst.last_t.numpy(), np.asarray(jst.last_t), atol=1e-3)
    assert tinfo.is_keyframe == bool(jinfo.is_keyframe)
    assert abs(tinfo.n_inliers - int(jinfo.n_inliers)) <= 0.02 * int(jinfo.n_inliers)


@pytest.mark.parametrize("window,every", [(1, 1), (4, 1), (4, 2), (4, 3)])
def test_forced_commit_matches_jax(seq, jax_run, window, every):
    """_commit_keyframe on both sides from identical inputs: the JAX
    state, the JAX frontend's features of the next frame, the last pose
    and the map->frame matches there. With window=4 the commit solves the
    window BA (the bench headline's local_ba_window) and culls over the
    four newest keyframes; with every > 1 (the hybrid cadence) the port
    takes the commit number from the host (the JAX package reads
    arch_count + num_kf on the device), and the two cadences of this state
    take one branch each."""
    cfg = dataclasses.replace(CFG, local_ba_window=window, window_ba_every=every)
    jcfg = JaxSlamConfig(**dataclasses.asdict(cfg))
    jcam, slam = jax_run
    st = slam.state
    img = _u8(seq.frames[int(st.frame_count)])
    imgf = jnp.asarray(img, jnp.float32) / 255.0
    feat = slam.frontend.extract(imgf, None)
    from racing_slam_tpu.ops import se3 as jse3
    from racing_slam_tpu.ops.matching import match_map_to_frame

    m = st.map
    mm = match_map_to_frame(
        jcam, jse3.pose_matrix(st.last_rvec, st.last_t), m.pos, m.valid, st.obs_desc,
        m.obs_valid & m.valid[:, None], feat.xy, feat.desc, feat.valid,
        jnp.zeros(feat.valid.shape, bool), jnp.zeros(m.valid.shape, bool), max_distance=0.8,
        radius_px=CFG.match_radius_px,
    )
    matches = jnp.where(mm.valid, mm.point_idx, -1)
    st = st._replace(last_feat=feat, last_matches=matches)
    commit = jax.jit(partial(jp._commit_keyframe, cam=jcam, cfg=jcfg,
                             matcher=slam.frontend.matcher))
    want = commit(st, imgf, feat, st.last_rvec, st.last_t, matches)

    tst = state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
    port_commit = partial(tp._commit_keyframe, tst, torch.from_numpy(np.array(imgf)),
                          tst.last_feat, tst.last_rvec, tst.last_t, tst.last_matches,
                          cam=Camera(*seq.cam), cfg=cfg, matcher=ClassicalFrontend().matcher)
    n = int(st.arch_count + st.num_kf)
    assert (n % 2 == 0) != (n % 3 == 0), n  # every=2 and every=3 take different branches
    if every > 1:
        with pytest.raises(ValueError, match="commit_no"):
            port_commit()
    got = port_commit(commit_no=n)
    g, w = state_to_numpy(got), want
    for name in ("num_kf", "last_kf_slot", "arch_count"):
        np.testing.assert_array_equal(getattr(g, name), np.asarray(getattr(w, name)))
    np.testing.assert_array_equal(g.kfs.frame_index, np.asarray(w.kfs.frame_index))
    gv, wv = g.map.valid, np.asarray(w.map.valid)
    assert (gv == wv).mean() >= 0.97 and wv.sum() > int(np.asarray(st.map.valid).sum())
    both = gv & wv
    err = np.linalg.norm(g.map.pos[both] - np.asarray(w.map.pos)[both], axis=-1)
    assert np.median(err) < 1e-3
    np.testing.assert_allclose(g.last_rvec, np.asarray(w.last_rvec), atol=1e-4)
    np.testing.assert_allclose(g.last_t, np.asarray(w.last_t), atol=1e-3)
    ok = np.asarray(w.map.obs_valid) & both[:, None]
    assert (g.map.obs_valid[both] == np.asarray(w.map.obs_valid)[both]).mean() > 0.97
    assert (g.map.obs_kf[ok] == np.asarray(w.map.obs_kf)[ok]).mean() > 0.97


def _ate(slam, seq):
    kf = slam.keyframe_indices()
    gt = seq.poses[kf]
    length = np.linalg.norm(camera_centers(gt)[-1] - camera_centers(gt)[0])
    return ate_rmse(slam.poses(), gt), length, kf


@pytest.mark.parametrize("mode,branch", [
    (dict(essential_matrix_estimation=True), True),
    (dict(pose_prediction="adaptive", adaptive_pred_inliers=1 << 30), True),  # starved
    (dict(pose_prediction="adaptive"), False),  # healthy: constant position
])
def test_prediction_step_matches_jax(seq, jax_run, mode, branch):
    cfg = dataclasses.replace(CFG, **mode)
    jcfg = JaxSlamConfig(**dataclasses.asdict(cfg))
    jcam, slam = jax_run
    st = slam.state
    assert int(st.last_inliers) >= SlamConfig().adaptive_pred_inliers  # a healthy state
    img = _u8(seq.frames[int(st.frame_count)])
    key = jax.random.PRNGKey(5)
    step = jax.jit(partial(jp.slam_step, cam=jcam, cfg=jcfg, frontend=slam.frontend))
    jst, jinfo = step(st, jnp.asarray(img), key, None)
    K = st.last_feat.xy.shape[0]
    uniforms = torch.from_numpy(np.array(jax.random.uniform(key, (cfg.ransac_hypotheses, K))))
    tst, tinfo = tp.slam_step(state_from_numpy(jax.tree.map(np.asarray, st), device="cpu"),
                              torch.from_numpy(img), None, cam=Camera(*seq.cam), cfg=cfg,
                              frontend=ClassicalFrontend(), uniforms=uniforms,
                              last_inliers=int(st.last_inliers))
    assert tinfo.essential_prediction == branch
    jm, tm = np.asarray(jst.last_matches), tst.last_matches.numpy()
    assert (jm >= 0).sum() > 50
    assert (jm == tm).mean() >= 0.97
    np.testing.assert_allclose(tst.last_rvec.numpy(), np.asarray(jst.last_rvec), atol=1e-4)
    np.testing.assert_allclose(tst.last_t.numpy(), np.asarray(jst.last_t), atol=1e-3)
    assert tinfo.is_keyframe == bool(jinfo.is_keyframe)
    assert abs(tinfo.n_inliers - int(jinfo.n_inliers)) <= 0.02 * int(jinfo.n_inliers)


# The adaptive case is starved on every frame (a threshold above any inlier
# count), so each frame takes the rescaled essential prediction.
PREDICTIONS = {
    "constant_position": dict(pose_prediction="constant_position"),
    "constant_velocity": dict(pose_prediction="constant_velocity"),
    "adaptive": dict(pose_prediction="adaptive", adaptive_pred_inliers=1 << 30),
    "essential": dict(essential_matrix_estimation=True),
}


@pytest.mark.parametrize("prediction", list(PREDICTIONS))
def test_slice_tracks_the_sequence(seq, prediction):
    cfg = SlamConfig(triangulate_points=True, bundle_adjust=True, optimize_pose=True,
                     cull_points=True, max_keyframes=16, map_capacity=2048,
                     **PREDICTIONS[prediction])
    slam = tp.Slam(seq.cam, ArraySource(seq.frames), cfg, device="cpu")
    assert slam.initialize()
    n = slam.run_batched(batch=8)
    ate, length, kf = _ate(slam, seq)
    assert len(kf) >= 4
    assert ate < 0.08 * length, f"ATE {ate} vs trajectory length {length}"
    assert slam.reprojection_error() < 2.0
    assert slam.host_syncs["track"] == n == slam.frames_tracked
    essential = prediction in ("adaptive", "essential")
    assert slam.essential_predictions == (n if essential else 0)


def test_run_batched_matches_per_frame_stepping(seq):
    a = tp.Slam(seq.cam, ArraySource(seq.frames), CFG, device="cpu")
    assert a.initialize()
    a.run()
    b = tp.Slam(seq.cam, ArraySource(seq.frames), CFG, device="cpu")
    assert b.initialize()
    b.run_batched(batch=5)
    np.testing.assert_array_equal(a.keyframe_indices(True), b.keyframe_indices(True))
    np.testing.assert_allclose(a.poses(True), b.poses(True), atol=1e-6)
    np.testing.assert_array_equal(a.points(), b.points())


def test_scale_path_tracks_the_sequence(seq):
    """Window BA (W=4), refinement every 5 frames and the banded matcher on
    (b)'s sequence: the same bound, a refinement at every 5 frames plus the
    closing one, one host read per tracked frame, and the fallback count
    read once at the end."""
    cfg = SlamConfig(triangulate_points=True, bundle_adjust=True, optimize_pose=True,
                     cull_points=True, max_keyframes=16, map_capacity=2048,
                     pose_prediction="constant_velocity", local_ba_window=4,
                     refine_every_frames=5, matching_backend="banded")
    slam = tp.Slam(seq.cam, ArraySource(seq.frames), cfg, device="cpu")
    assert slam.initialize()
    n = slam.run_batched(batch=4)
    ate, length, kf = _ate(slam, seq)
    assert len(kf) >= 4
    assert ate < 0.08 * length, f"ATE {ate} vs trajectory length {length}"
    assert slam.reprojection_error() < 2.0
    assert slam.host_syncs["track"] == n == slam.frames_tracked
    assert len(slam.refine_costs) == n // 5 + (n % 5 > 0)
    assert all(np.isfinite(float(c)) for c in slam.refine_costs)
    assert 0 <= slam.banded_fallbacks() <= 2 * n


def test_refine_cadence_is_independent_of_the_batch(seq):
    """The refinement fires after exactly refine_every_frames frames,
    whatever the batch: three batch sizes give the same keyframes, poses,
    points and refinement count."""
    cfg = dataclasses.replace(CFG, refine_every_frames=4, refine_iters=4)
    runs = []
    for batch in (1, 3, 16):
        s = tp.Slam(seq.cam, ArraySource(seq.frames), cfg, device="cpu")
        assert s.initialize()
        s.run_batched(batch=batch)
        runs.append(s)
    for s in runs[1:]:
        np.testing.assert_array_equal(runs[0].keyframe_indices(True), s.keyframe_indices(True))
        np.testing.assert_allclose(runs[0].poses(True), s.poses(True), atol=1e-6)
        np.testing.assert_array_equal(runs[0].points(), s.points())
        assert len(s.refine_costs) == len(runs[0].refine_costs) >= 3


@pytest.mark.parametrize("override", [
    dict(pose_prediction="adaptive"), dict(essential_matrix_estimation=True),
])
def test_out_of_slice_config_raises(seq, override):
    """The two values the port once refused (adaptive and essential-matrix
    prediction) now build a `Slam`; a prediction the JAX package does not
    know still raises."""
    slam = tp.Slam(seq.cam, [], SlamConfig(**override), device="cpu")
    assert slam.cfg == SlamConfig(**override) and slam.essential_predictions == 0
    with pytest.raises(ValueError, match="pose_prediction"):
        tp.Slam(seq.cam, [], SlamConfig(**{**override, "pose_prediction": "essential"}),
                device="cpu")


@pytest.mark.parametrize("override", [
    dict(local_ba_window=4), dict(refine_every_frames=48), dict(matching_backend="banded"),
])
def test_scale_path_config_is_accepted(seq, override):
    """The values slices 2 and 4 brought build a `Slam`."""
    slam = tp.Slam(seq.cam, [], SlamConfig(**override), device="cpu")
    assert slam.cfg == SlamConfig(**override) and slam.refine_costs == []


def test_slam_without_a_card_raises(seq):
    """The card is the default device: without one, Slam refuses to start
    unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.Slam(seq.cam, [], SlamConfig())
    assert tp.Slam(seq.cam, [], SlamConfig(), device="cpu").state.map.pos.device.type == "cpu"


@pytest.mark.parametrize("override", [
    dict(matching_backend="xla"), dict(ba_backend="pallas"), dict(frontend_backend="xla"),
])
def test_jax_backend_choices_are_refused(seq, override):
    """The port chooses kernel or twin by the tensors' device; the JAX
    package's XLA/Pallas switches have no meaning here and are refused."""
    with pytest.raises(ValueError, match="only 'auto'"):
        tp.Slam(seq.cam, [], SlamConfig(**override))


def test_obs_desc_cache_matches_full_regather(seq):
    """The per-commit obs-descriptor refresh equals the full [P, O, D]
    regather on every valid observation (invalid entries may hold stale
    values: every consumer masks them); 6 keyframe slots, so evictions and
    slot reuse happen."""
    cfg = SlamConfig(triangulate_points=True, bundle_adjust=True, optimize_pose=True,
                     cull_points=True, max_keyframes=6, map_capacity=1024)
    slam = tp.Slam(seq.cam, ArraySource(seq.frames), cfg, device="cpu")
    assert slam.initialize()
    slam.run()
    st = slam.state
    full, dvalid = st.map.observation_descriptors(st.kfs)
    assert int(st.arch_count) > 0 and int(dvalid.sum()) > 100
    torch.testing.assert_close(st.obs_desc[dvalid], full.to(torch.bfloat16)[dvalid],
                               atol=0, rtol=0)


def test_compact_cull_matches_full_sweep(seq):
    """The commit cull over the points a commit touched reproduces the full
    [P, O] sweep (cull_budget=0 forces it): two runs, with evictions and the
    window BA, end with the same map and keyframes."""
    base = dict(triangulate_points=True, bundle_adjust=True, optimize_pose=True,
                cull_points=True, max_keyframes=6, map_capacity=1024, local_ba_window=4)
    runs = []
    for extra in ({}, dict(cull_budget=0)):
        s = tp.Slam(seq.cam, ArraySource(seq.frames), SlamConfig(**base, **extra), device="cpu")
        assert s.initialize()
        s.run()
        runs.append(s.state)
    a, b = runs
    assert torch.equal(a.map.valid, b.map.valid)
    assert torch.equal(a.kfs.frame_index, b.kfs.frame_index)
    torch.testing.assert_close(a.kfs.rvec, b.kfs.rvec, atol=1e-5, rtol=0)
    torch.testing.assert_close(a.map.pos, b.map.pos, atol=1e-4, rtol=0)
