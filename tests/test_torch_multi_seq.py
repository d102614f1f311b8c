"""The port's multi-sequence tracking (parallel/multi_seq.py,
slam.pipeline.slam_step_multi) on tests/test_multi_seq.py's tiny world
(2 sequences, 10 frames, 320x240), on the CPU.

(a) MultiSlam against the port's Slam run sequence by sequence with
    seed=i: equal kfs.valid and num_kf, last_rvec / last_t within 1e-5,
    and every leaf of the state equal to the bit (the batched twins equal
    the per-row ones and se3's products sum in a fixed order, so this is
    far tighter than the JAX package's 5e-2 between its vmapped and single
    programs), under constant-position and constant-velocity prediction.
(b) From the JAX package's MultiSlam.initialize() states on its
    {"seq": 2, "lm": 4} CPU mesh, converted row by row: slam_step_multi
    against JAX's multi_sequence_step frame by frame over 6 frames, rvec
    1e-4 and t 1e-3 per row (tests/test_torch_pipeline.py's one-step
    rule), equal num_kf.
(c) Loss recovery (tests/test_multi_seq.py's scene cut): only the cut
    sequence is archived and re-bootstrapped; a cut too close to the end of
    its stream marks the sequence finished and leaves its row blank.
(d) refine_map: each row equals full_ba + apply_refinement on that row,
    and a refinement is one full_ba call of all the rows.
(e) The batched K2, K3 and K4 twins at S=3 equal three single calls
    (atol 0), and the batched frontend equals per-frame extraction.
(f) A lockstep frame makes one host read and one K1, two K2 and two K3
    calls, whatever S; inactive rows are left as they were; the rows that
    commit on it make one batched K4 call and no single one.
(g) The keyframe commit over the rows that commit on one lockstep frame:
    with every row committing on every frame (min_commit_inliers above any
    inlier count), (a) every leaf to the bit with one batched K4 twin
    call a lockstep frame, and at local_ba_window=4 with one window_ba
    call of all the rows a lockstep frame, after each frame, and (b)
    against JAX's step at local_ba_window 1 and 4; on the hybrid cadence
    (local_ba_window=4, window_ba_every=2), rows on different commit
    numbers split between one K4 call and one window_ba call on a
    lockstep frame, two of three rows taking the window together, each
    row bit-equal to its own slam_step.
(h) The pose predictions and the banded matcher in the lockstep step:
    (a) under essential_matrix_estimation, adaptive (as it comes, where
    one row takes the essential prediction on a frame and the other does
    not, and forced with a threshold above any inlier count) and
    matching_backend="banded" (as it comes, and with band tiles narrowed
    so that a row's band does not fit while the other's does: the
    320x240 world never has the more than 1024 valid keypoints that make
    the default band fail); each row's essential predictions and banded
    fallbacks equal its Slam's. And (b) under the same configurations,
    each row's RANSAC uniforms drawn from JAX's key for that row and frame
    as jax.random.uniform(key, (H, K)) (tests/test_torch_pipeline.py's
    rule): JAX's vmapped step runs the banded Pallas kernel in interpret
    mode under vmap on the CPU, so the banded case holds the port against
    JAX's slam_step row by row instead.
"""

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_slam_tpu.ops.camera import Camera as JaxCamera
from racing_slam_tpu.parallel.mesh import make_mesh as jax_make_mesh
from racing_slam_tpu.parallel.multi_seq import MultiSlam as JaxMultiSlam
from racing_slam_tpu.parallel.multi_seq import multi_sequence_step as jax_multi_sequence_step
from racing_slam_tpu.slam import pipeline as jp
from racing_slam_tpu.slam.config import SlamConfig as JaxSlamConfig
from racing_slam_tpu.utils.video import ArraySource as JaxArraySource
from racing_slam_tpu_torch.ops import matching
from racing_slam_tpu_torch.ops.ba import full_ba
from racing_slam_tpu_torch.ops.kernels import frontend as k1
from racing_slam_tpu_torch.ops.kernels import match as k2
from racing_slam_tpu_torch.ops.kernels import motion_ba as k3
from racing_slam_tpu_torch.ops.kernels import structure_ba as k4
from racing_slam_tpu_torch.parallel.multi_seq import MultiSlam, batched_state
from racing_slam_tpu_torch.parallel.refine import apply_refinement, build_global_problem
from racing_slam_tpu_torch.slam import pipeline as tp
from racing_slam_tpu_torch.slam.frontend import ClassicalFrontend
from racing_slam_tpu_torch.slam.state import stack_states, state_row, tree_map
from racing_slam_tpu_torch.utils.checkpoint import (
    _named_leaves,
    load_state_sharded,
    save_state_sharded,
)
from racing_slam_tpu_torch.utils.convert import state_from_numpy
from racing_slam_tpu_torch.utils.synthetic import make_sequence
from racing_slam_tpu_torch.utils.video import ArraySource
from torch_multi_world import tiny_cfg, tiny_world

torch.set_num_threads(2)


def _u8(f):
    return np.clip(f * 255.0, 0, 255).astype(np.uint8)


def _equal_states(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_named_leaves(a).values(),
                                                 _named_leaves(b).values()))


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def _multi_against_per_sequence_slam(world, cfg, frames: int, batch: int):
    cam, seqs = world
    single, slams = [], []
    for i, s in enumerate(seqs):
        slam = tp.Slam(cam, ArraySource(s.frames), cfg, seed=i, device="cpu")
        assert slam.initialize()
        slam.run_batched(max_frames=frames, batch=batch)
        single.append(slam.state)
        slams.append(slam)
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], None, cfg, device="cpu")
    assert ms.initialize()
    assert ms.run_batched(max_frames=frames, batch=batch) == frames
    assert ms.host_syncs == ms.frames_stepped == frames
    assert ms.essential_predictions == [s.essential_predictions for s in slams]
    if cfg.matching_backend == "banded":
        assert ms.banded_fallbacks() == [s.banded_fallbacks() for s in slams]
    for got, want in zip(ms.states_per_sequence(), single):
        assert torch.equal(got.kfs.valid, want.kfs.valid)
        assert int(got.num_kf) == int(want.num_kf)
        np.testing.assert_allclose(got.last_rvec.numpy(), want.last_rvec.numpy(), atol=1e-5)
        np.testing.assert_allclose(got.last_t.numpy(), want.last_t.numpy(), atol=1e-5)
        assert _equal_states(got, want)  # every leaf, to the bit
    return ms


def _count_k4(monkeypatch) -> dict:
    """Counts K4's twin calls: `batched`, the C of each call with a leading
    C (a lockstep frame's commit), and `single`, the calls of one problem
    (not those the batched twin makes for its rows)."""
    calls = {"batched": [], "single": 0}
    orig = k4.structure_ba_lm_reference
    inside = []

    def counted(*a, **kw):
        if a[2].dim() == 3:
            calls["batched"].append(a[2].shape[0])
            inside.append(True)
            try:
                return orig(*a, **kw)
            finally:
                inside.pop()
        calls["single"] += not inside
        return orig(*a, **kw)

    monkeypatch.setattr(k4, "structure_ba_lm_reference", counted)
    return calls


def test_multi_slam_matches_per_sequence_slam(world):
    _multi_against_per_sequence_slam(world, tiny_cfg(), frames=6, batch=3)


# The absolute commit floor above any inlier count: every row commits on
# every frame (slam/config.py min_commit_inliers, pipeline.py _track).
FORCED = dict(min_commit_inliers=1 << 30)


def test_multi_slam_matches_per_sequence_slam_forced_commits(world, monkeypatch):
    """(g) (a): every leaf to the bit after 8 lockstep frames (batches of
    4), both rows committing on each, with one batched K4 twin call of the
    two rows a lockstep frame; single calls only at the bootstraps (the
    Slams' two, their 16 commits, and MultiSlam's two)."""
    calls = _count_k4(monkeypatch)
    cfg = tiny_cfg(pose_prediction="constant_velocity", **FORCED)
    ms = _multi_against_per_sequence_slam(world, cfg, frames=8, batch=4)
    assert calls["batched"] == [2] * 8, calls
    assert calls["single"] == 2 * (1 + 8) + 2, calls
    for st in ms.states_per_sequence():  # every frame committed, the oldest evicted
        assert int(st.arch_count) + int(st.num_kf) == 2 + 8
    # A commit of every row writes the stacked state whole: the kernels
    # take its leaves as they are and need them contiguous.
    assert all(x.is_contiguous() for x in _named_leaves(ms.states).values())


def _count_window_ba(monkeypatch) -> list:
    """Records slam.pipeline's window_ba calls: the C of each stacked call
    (the rows that take the window on a lockstep frame), 0 for a call of
    one problem (a Slam's commit)."""
    calls = []

    def counted(cam, prob, *a, _orig=tp.window_ba, **kw):
        calls.append(prob.points.shape[0] if prob.points.dim() == 3 else 0)
        return _orig(cam, prob, *a, **kw)

    monkeypatch.setattr(tp, "window_ba", counted)
    return calls


def test_window_commits_bit_equal_to_each_slam_every_frame(world, monkeypatch):
    """(g) (a) at local_ba_window=4 with forced commits: MultiSlam and each
    row's Slam stepped a lockstep frame at a time over 8 frames, every leaf
    of every row bit-equal to its Slam after each; each lockstep frame
    makes exactly one window_ba call, of both rows, and no K4 launch."""
    cam, seqs = world
    cfg = tiny_cfg(pose_prediction="constant_velocity", local_ba_window=4, **FORCED)
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], None, cfg, device="cpu")
    assert ms.initialize()
    slams = [tp.Slam(cam, ArraySource(s.frames), cfg, seed=i, device="cpu")
             for i, s in enumerate(seqs)]
    assert all([sl.initialize() for sl in slams])
    k4_calls = _count_k4(monkeypatch)
    windows = _count_window_ba(monkeypatch)
    for j in range(8):
        del windows[:]
        assert ms.run_batched(max_frames=1, batch=1) == 1
        assert windows == [2], (j, windows)
        for i, sl in enumerate(slams):
            assert sl.run_batched(max_frames=1, batch=1) == 1
            assert _equal_states(state_row(ms.states, i), sl.state), (j, i)
        assert windows == [2, 0, 0], (j, windows)
    assert k4_calls == {"batched": [], "single": 0}, k4_calls
    for st in ms.states_per_sequence():  # every frame committed, the oldest evicted
        assert int(st.arch_count) + int(st.num_kf) == 2 + 8
    assert all(x.is_contiguous() for x in _named_leaves(ms.states).values())


def _hybrid_cadence(cam, streams: list, monkeypatch, nos: list, frames: int = 4) -> None:
    """local_ba_window=4 with window_ba_every=2 and forced commits, the rows
    starting on commit numbers `nos`: on each lockstep frame the rows on
    an even commit number take the window (one window_ba call of them all)
    and the others the reference shape (one K4 call of them all); each row
    bit-equal to slam_step on that row with its commit number. `streams`
    are the rows' frame lists."""
    S = len(streams)
    cfg = tiny_cfg(pose_prediction="constant_velocity", local_ba_window=4, window_ba_every=2,
                   **FORCED)
    ms = MultiSlam(cam, [ArraySource(f) for f in streams], None, cfg, device="cpu")
    assert ms.initialize()
    calls = _count_k4(monkeypatch)
    windows = _count_window_ba(monkeypatch)
    states = ms.states
    rows = [tree_map(torch.clone, state_row(states, i)) for i in range(S)]
    start = states.frame_count.tolist()
    k4_rows = 0
    for j in range(frames):
        imgs = np.stack([_u8(streams[i][start[i] + j]) for i in range(S)])
        n_single, n_batched = calls["single"], len(calls["batched"])
        del windows[:]
        states, info = tp.slam_step_multi(states, torch.from_numpy(imgs), [True] * S, None,
                                          cam=cam, cfg=cfg, frontend=ms.frontend, commit_nos=nos)
        assert info.is_keyframe == [True] * S
        n_window = sum(n % 2 == 0 for n in nos)
        assert windows == ([n_window] if n_window else []), (j, windows)
        assert calls["batched"][n_batched:] == ([S - n_window] if n_window < S else []), calls
        assert calls["single"] == n_single, calls
        k4_rows += S - n_window
        for i in range(S):
            rows[i], _ = tp.slam_step(rows[i], torch.from_numpy(imgs[i]), None, cam=cam, cfg=cfg,
                                      frontend=ms.frontend, commit_no=nos[i])
            assert _equal_states(state_row(states, i), rows[i]), (j, i)
        nos = [n + 1 for n in nos]
    assert calls["single"] == k4_rows  # the rows' own slam_step commits on K4


def test_hybrid_cadence_rows_split_between_k4_and_window_ba(world, monkeypatch):
    """(g): the hybrid cadence (_hybrid_cadence) with the two rows on commit
    numbers of different parity, so that on each lockstep frame one row's
    commit takes the window (a window_ba call of one problem) and the
    other's the reference shape (a K4 call of one problem), the two
    swapping from frame to frame; each row bit-equal to its own slam_step,
    over 4 frames."""
    cam, seqs = world
    _hybrid_cadence(cam, [s.frames for s in seqs], monkeypatch, [2, 3])


def test_hybrid_cadence_two_rows_take_the_window_together(world, monkeypatch):
    """(g): the hybrid cadence over three rows (the two worlds, and the
    first from its second frame) on commit numbers 2, 3 and 4: rows 0 and
    2 take the window on the same frame (one window_ba call of C = 2 beside
    one K4 call of C = 1), then row 1 alone beside the other two (C = 1 and
    C = 2), and so on over 4 frames, each row bit-equal to its own
    slam_step."""
    cam, seqs = world
    _hybrid_cadence(cam, [seqs[0].frames, seqs[1].frames, seqs[0].frames[1:]], monkeypatch,
                    [2, 3, 4])


def test_multi_slam_matches_per_sequence_slam_constant_velocity(world):
    """(a) under the chip_smoke multi path's prediction, over every frame
    the worlds have left after the bootstrap."""
    _multi_against_per_sequence_slam(world, tiny_cfg(pose_prediction="constant_velocity"),
                                     frames=8, batch=4)


def _narrow_bands(monkeypatch):
    """Band tiles of 96 keypoints and point tiles of 64 rows, so that on the
    tiny world the second row's band does not fit on its first frames
    while the first row's always does."""
    monkeypatch.setattr(matching, "_banded_stage1",
                        functools.partial(matching._banded_stage1, tile_p=64, tile_k=96))


PREDICTION_CASES = {
    "essential": dict(essential_matrix_estimation=True),
    "adaptive": dict(pose_prediction="adaptive"),
    "adaptive_forced": dict(pose_prediction="adaptive", adaptive_pred_inliers=1 << 30),
    "banded": dict(matching_backend="banded"),
    "banded_no_fit": dict(matching_backend="banded"),
}


@pytest.mark.parametrize("case", list(PREDICTION_CASES))
def test_multi_slam_matches_per_sequence_slam_predictions(world, monkeypatch, case):
    """(h) (a): every leaf to the bit after 8 lockstep frames (batches of
    4), the per-row counters equal, and each case does what it names."""
    if case == "banded_no_fit":
        _narrow_bands(monkeypatch)
    ms = _multi_against_per_sequence_slam(world, tiny_cfg(**PREDICTION_CASES[case]), frames=8,
                                          batch=4)
    if case in ("essential", "adaptive_forced"):
        assert ms.essential_predictions == [8, 8]
    elif case == "adaptive":
        assert 0 < sum(ms.essential_predictions) < 16  # a frame with one row on each branch
    elif case == "banded":
        assert ms.banded_fallbacks() == [0, 0]
    else:
        fb = ms.banded_fallbacks()
        assert 0 == fb[0] < fb[1] < 16, fb


def test_adaptive_signal_follows_the_rebootstrap(world):
    """A row re-bootstrapped mid-run (as the loss recovery does) seeds its
    host inlier count, the adaptive choice's signal, with its state's (the
    bootstrap's match count), and the next lockstep frame chooses each
    row's prediction from it."""
    cam, seqs = world
    cfg = tiny_cfg(pose_prediction="adaptive", adaptive_pred_inliers=60)
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], None, cfg, device="cpu")
    assert ms.initialize()
    ms.run_batched(max_frames=2, batch=2)
    ms._reinit_sequence(0)
    signal = [sl._last_inliers for sl in ms._slams]
    assert signal == ms.states.last_inliers.tolist()
    assert signal[0] == int(ms._slams[0].state.last_inliers) > 0
    before = list(ms.essential_predictions)
    ms.run_batched(max_frames=1, batch=1)
    took = [a - b for a, b in zip(ms.essential_predictions, before)]
    assert took == [int(n < cfg.adaptive_pred_inliers) for n in signal]
    assert [sl._last_inliers for sl in ms._slams] == ms.states.last_inliers.tolist()


@pytest.fixture(scope="module")
def jax_boot(world):
    """The JAX package's MultiSlam bootstrapped on its {"seq": 2, "lm": 4}
    CPU mesh (the bootstrap reads neither the prediction nor the map
    matcher): the mesh, the frontend and the stacked states as numpy."""
    cam, seqs = world
    mesh = jax_make_mesh({"seq": 2, "lm": 4})
    jcfg = JaxSlamConfig(**dataclasses.asdict(tiny_cfg(pose_prediction="constant_velocity")))
    jms = JaxMultiSlam(JaxCamera(*cam), [JaxArraySource(s.frames) for s in seqs], mesh, jcfg)
    assert jms.initialize()
    return mesh, jms.frontend, jax.tree.map(np.asarray, jms.states)


@pytest.mark.parametrize("case", ["essential", "adaptive_forced", "banded"])
def test_step_matches_jax_multi_sequence_step_predictions(world, jax_boot, case):
    """(h) (b): slam_step_multi against JAX's vmapped step (its slam_step
    row by row for the banded matcher) over 6 frames from JAX's
    bootstrapped states, each frame one step from JAX's states of the
    frame before (the one-step rule), rvec 1e-4, t 1e-3, equal num_kf.

    These steps predict and track and do not commit (keyframe_match_ratio
    0), with SlamConfig's 10 motion-BA iterations. The commit is the
    classical path's, and the tests above and below hold it; on this world
    of ~100 map points a commit from equal states can triangulate or cull
    one weak-depth point differently in the two packages (or in one
    package under another CPU thread count), which moves the committed
    pose by up to 1.1e-3 rad, under the classical prediction and on the
    tree before the predictions came in as well."""
    cam, seqs = world
    cfg = tiny_cfg(**{"pose_prediction": "constant_velocity", "motion_ba_iters": 10,
                      "keyframe_match_ratio": 0.0, **PREDICTION_CASES[case]})
    jcfg = JaxSlamConfig(**dataclasses.asdict(cfg))
    jcam = JaxCamera(*cam)
    mesh, jfrontend, jstates = jax_boot
    if case == "banded":
        one = jax.jit(partial(jp.slam_step, cam=jcam, cfg=jcfg, frontend=jfrontend))

        def jstep(st, imgs, keys):
            outs = [one(jax.tree.map(lambda x, i=i: x[i], st), jnp.asarray(imgs[i]), keys[i],
                        None)[0] for i in range(2)]
            return jax.tree.map(lambda *x: np.stack([np.asarray(v) for v in x]), *outs)
    else:
        multi = jax_multi_sequence_step(mesh, cam=jcam, cfg=jcfg, frontend=jfrontend)

        def jstep(st, imgs, keys):
            out = multi(st, imgs[:, None], np.asarray(keys).reshape(2, 1, -1),
                        np.ones((2, 1), bool), None)[0]
            return jax.tree.map(np.asarray, out)
    frontend = ClassicalFrontend(cell=cfg.cell, n_per_cell=cfg.n_per_cell,
                                 max_distance=cfg.max_match_distance)
    start = jstates.frame_count.tolist()
    K = jstates.last_feat.xy.shape[1]
    key = jax.random.PRNGKey(3)
    essential = 0
    for j in range(6):
        imgs = np.stack([_u8(seqs[i].frames[start[i] + j]) for i in range(2)])
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, 2)
        uniforms = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
            keys[i], (cfg.ransac_hypotheses, K))) for i in range(2)]))
        states = stack_states([state_from_numpy(jax.tree.map(lambda x, i=i: x[i], jstates),
                                                device="cpu") for i in range(2)], device="cpu")
        jstates = jstep(jstates, imgs, keys)
        states, info = tp.slam_step_multi(
            states, torch.from_numpy(imgs), [True, True], None, cam=cam, cfg=cfg,
            frontend=frontend, uniforms=uniforms, last_inliers=states.last_inliers.tolist())
        essential += sum(info.essential_prediction)
        np.testing.assert_allclose(states.last_rvec.numpy(), jstates.last_rvec, atol=1e-4)
        np.testing.assert_allclose(states.last_t.numpy(), jstates.last_t, atol=1e-3)
        np.testing.assert_array_equal(states.num_kf.numpy(), jstates.num_kf)
    assert not any(info.is_keyframe)
    assert essential == (0 if case == "banded" else 12)
    assert (info.band_fallbacks is not None) == (case == "banded")


def _against_jax_lockstep(world, mesh, jfrontend, jstates, cfg, frames: int = 6,
                          one_step: bool = False) -> int:
    """slam_step_multi from JAX's bootstrapped states against JAX's
    multi_sequence_step over `frames` lockstep frames, each side carrying
    its own states (with `one_step`, the port's from JAX's states of the
    frame before: the one-step rule), rvec 1e-4, t 1e-3 per row, equal
    num_kf and frame_count; returns the row commits."""
    cam, seqs = world
    jstep = jax_multi_sequence_step(mesh, cam=JaxCamera(*cam),
                                    cfg=JaxSlamConfig(**dataclasses.asdict(cfg)),
                                    frontend=jfrontend)
    rows = [jax.tree.map(lambda x, i=i: np.asarray(x)[i], jstates) for i in range(2)]
    states = stack_states([state_from_numpy(r, device="cpu") for r in rows], device="cpu")
    frontend = ClassicalFrontend(cell=cfg.cell, n_per_cell=cfg.n_per_cell,
                                 max_distance=cfg.max_match_distance)
    start = [int(r.frame_count) for r in rows]
    key = jax.random.PRNGKey(0)
    commits = 0
    for j in range(frames):
        imgs = np.stack([_u8(seqs[i].frames[start[i] + j]) for i in range(2)])
        keys = np.asarray(jax.random.split(key, 2)).reshape(2, 1, -1)
        if one_step:
            states = stack_states([state_from_numpy(jax.tree.map(
                lambda x, i=i: np.asarray(x)[i], jstates), device="cpu") for i in range(2)],
                device="cpu")
        jstates, jinfo = jstep(jstates, imgs[:, None], keys, np.ones((2, 1), bool), None)
        states, info = tp.slam_step_multi(states, torch.from_numpy(imgs), [True, True], None,
                                          cam=cam, cfg=cfg, frontend=frontend)
        commits += sum(info.is_keyframe)
        np.testing.assert_allclose(states.last_rvec.numpy(), np.asarray(jstates.last_rvec),
                                   atol=1e-4)
        np.testing.assert_allclose(states.last_t.numpy(), np.asarray(jstates.last_t), atol=1e-3)
        np.testing.assert_array_equal(states.num_kf.numpy(), np.asarray(jstates.num_kf))
        np.testing.assert_array_equal(states.frame_count.numpy(), np.asarray(jstates.frame_count))
    return commits


def test_step_matches_jax_multi_sequence_step(world):
    cam, seqs = world
    cfg = tiny_cfg(pose_prediction="constant_velocity")
    mesh = jax_make_mesh({"seq": 2, "lm": 4})
    jms = JaxMultiSlam(JaxCamera(*cam), [JaxArraySource(s.frames) for s in seqs], mesh,
                       JaxSlamConfig(**dataclasses.asdict(cfg)))
    assert jms.initialize()
    commits = _against_jax_lockstep(world, mesh, jms.frontend, jms.states, cfg)
    assert commits > 0  # the commit path ran on some row


@pytest.mark.parametrize("window", [1, 4])
def test_step_matches_jax_multi_sequence_step_forced_commits(world, jax_boot, window):
    """(g) (b): both rows commit on each of the 6 lockstep frames (one
    commit over the two rows each: K4, or one window_ba call at
    local_ba_window=4), from JAX's bootstrapped states, under
    the one-step rule (test_step_matches_jax_multi_sequence_step_predictions
    says why: carried over six commits, one weak-depth point of row 0
    leaves the two packages' maps apart at the fifth, 138 points against
    137, and the pose 6.5e-4 rad apart)."""
    mesh, jfrontend, jstates = jax_boot
    cfg = tiny_cfg(pose_prediction="constant_velocity", local_ba_window=window, **FORCED)
    assert _against_jax_lockstep(world, mesh, jfrontend, jstates, cfg, one_step=True) == 12


def test_loss_recovery_archives_only_the_cut_sequence():
    """tests/test_multi_seq.py::test_multi_seq_loss_recovery's worlds: a
    hard scene cut at frame 8 of sequence 0; and a cut 3 frames before the
    end of a stream, too late to re-bootstrap."""
    cam = tiny_world()[0]
    step = np.array([0.10, 0.01, 0.16], np.float32)
    a, b, c = [make_sequence(np.random.default_rng(s), n_frames=n, cam=cam, n_sprites=140,
                             step_t=step) for s, n in ((5, 8), (99, 20), (7, 28))]
    cfg = tiny_cfg(max_keyframes=8, map_capacity=1024, reinit_on_lost=True,
                   lost_check_interval=1)
    ms = MultiSlam(cam, [ArraySource(a.frames + b.frames), ArraySource(c.frames)], None, cfg,
                   device="cpu")
    assert ms.initialize()
    ms.run_batched(batch=4)
    assert len(ms.segments) >= 1 and all(seg["seq"] == 0 for seg in ms.segments)
    assert ms.segments[0]["poses"].shape[0] >= 2
    assert not ms.finished.any()
    states = ms.states_per_sequence()
    assert int(states[0].num_kf) >= 2 and int(states[1].num_kf) >= 2
    assert int(states[0].frame_count) > len(a.frames)  # re-bootstrapped on the second world

    late = MultiSlam(cam, [ArraySource(c.frames[:20] + b.frames[:3]), ArraySource(c.frames)],
                     None, cfg, device="cpu")
    assert late.initialize()
    late.run_batched(batch=4)
    assert late.finished.tolist() == [True, False]
    assert [seg["seq"] for seg in late.segments] == [0]
    states = late.states_per_sequence()
    assert int(states[0].num_kf) == 0 and not bool(states[0].map.valid.any())
    assert int(states[1].num_kf) >= 2


def test_refine_map_equals_full_ba_per_row(world, monkeypatch):
    """(d): each row equals full_ba + apply_refinement on that row, to the
    bit, and a refinement is one full_ba call of all the rows."""
    from racing_slam_tpu_torch.parallel import dist_ba

    cam, seqs = world
    cfg = tiny_cfg()
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], None, cfg, refine_every=1,
                   refine_iters=4, device="cpu")
    assert ms.initialize()
    ms.run_batched(max_frames=3, batch=3)
    assert len(ms.refine_costs) == 1
    before = ms.states_per_sequence()
    solves = []
    monkeypatch.setattr(dist_ba, "full_ba", lambda cam, prob, *a, _f=dist_ba.full_ba, **kw: (
        solves.append(prob.points.shape[:-2]) or _f(cam, prob, *a, **kw)))
    cost = ms.refine_map()
    assert solves == [(2,)], solves
    for i, row in enumerate(before):
        res = full_ba(cam, build_global_problem(row), max_iters=4)
        want = apply_refinement(row, res)
        assert _equal_states(state_row(ms.states, i), want)
        assert torch.equal(cost[i], res.cost)


def test_batched_twins_equal_single_calls():
    rng = np.random.default_rng(5)
    S, P, O, D, K = 3, 200, 4, 128, 300
    kp_uv = rng.uniform(0, 320, (S, K, 2)).astype(np.float32)
    kp = rng.standard_normal((S, K, D)).astype(np.float32)
    src = rng.integers(0, K, (S, P))
    obs = np.stack([kp[s][src[s]] for s in range(S)])[:, :, None] + 0.2 * rng.standard_normal(
        (S, P, O, D)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (
        np.stack([kp_uv[s][src[s]] for s in range(S)]) + rng.uniform(-5, 5, (S, P, 2)).astype(
            np.float32), rng.uniform(size=(S, P)) < 0.8, obs, rng.uniform(size=(S, P, O)) < 0.7,
        kp_uv, kp, rng.uniform(size=(S, K)) < 0.9)]
    args[2] = args[2].to(torch.bfloat16)
    bk, bd = k2.guided_match_stage1(*args, radius_px=20.0)
    skip = torch.tensor([True, False, True])
    sk, sd = k2.guided_match_stage1(*args, radius_px=20.0, skip=skip)
    for s in range(S):
        rk, rd = k2.guided_match_stage1(*[a[s] for a in args], radius_px=20.0)
        assert torch.equal(bk[s], rk) and torch.equal(bd[s], rd)
        if skip[s]:
            assert bool((sk[s] == 0).all()) and bool((sd[s] == k2.BIG).all())
        else:
            assert torch.equal(sk[s], rk) and torch.equal(sd[s], rd)

    X = rng.uniform(-3, 3, (S, K, 3)).astype(np.float32)
    X[..., 2] += 8.0
    uv = (240.0 * X[..., :2] / X[..., 2:] + 160.0 + rng.normal(0, 0.5, (S, K, 2))).astype(
        np.float32)
    pose0 = rng.normal(0, 0.02, (S, 6)).astype(np.float32)
    valid = rng.uniform(size=(S, K)) < 0.7
    margs = [torch.from_numpy(a) for a in (pose0, uv, X, valid)]
    kw = dict(fx=240.0, cx=160.0, cy=120.0, max_iters=5, huber_delta=0.01)
    out = k3.motion_ba_lm(*margs, **kw)
    assert out.shape == (S, 8)
    for s in range(S):
        assert torch.equal(out[s], k3.motion_ba_lm(*[a[s] for a in margs], **kw))

    # K4: S commit problems of P points, each its own free slot of F = 6
    # cameras and its own frozen points.
    F = 6
    rv = rng.normal(0, 0.01, (S, F, 3)).astype(np.float32)
    tv = rng.normal(0, 0.3, (S, F, 3)).astype(np.float32)
    Xp = np.concatenate([rng.uniform(-3, 3, (S, P, 2)), rng.uniform(6, 12, (S, P, 1))], -1)
    obs_cam = rng.integers(0, F, (S, P, O))
    obs_uv = rng.uniform(0, 320, (S, P, O, 2)).astype(np.float32)
    obs_uv[..., :] = 240.0 * Xp[:, :, None, :2] / Xp[:, :, None, 2:] + 160.0 + rng.normal(
        0, 1.0, (S, P, O, 2))
    sargs = [torch.from_numpy(a) for a in (
        rv, tv, Xp.astype(np.float32), obs_cam.astype(np.int64), obs_uv,
        rng.uniform(size=(S, P, O)) < 0.8, np.arange(P)[None, :] >= np.array([[0], [20], [50]]),
        np.array([F - 1, 2, 0]))]
    kw = dict(fx=240.0, cx=160.0, cy=120.0, max_iters=4, huber_delta=0.01)
    out, pts = k4.structure_ba_lm(*sargs, **kw)
    assert out.shape == (S, 8) and pts.shape == (S, P, 3)
    for s in range(S):
        one, one_pts = k4.structure_ba_lm(*[a[s] for a in sargs], **kw)
        assert torch.equal(out[s], one) and torch.equal(pts[s], one_pts)


def test_batched_frontend_equals_per_frame(world):
    _, seqs = world
    fe = ClassicalFrontend()
    imgs = torch.from_numpy(np.stack([seqs[0].frames[0], seqs[1].frames[3]]).astype(np.float32))
    feats = fe.extract(imgs)
    for s in range(2):
        one = fe.extract(imgs[s])
        for a, b in zip(feats, one):
            assert torch.equal(a[s], b)


def test_lockstep_frame_launches_and_inactive_rows(world, monkeypatch):
    """(f): a frame with row 1 inactive, then a frame on which both rows
    commit (forced): one K1, two K2 and two K3 calls each, and on the
    second one batched K4 twin call of the two rows and no single one."""
    cam, seqs = world
    cfg = tiny_cfg()
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], None, cfg, device="cpu")
    assert ms.initialize()
    calls = {"k1": 0, "k2": 0, "k3": 0}
    # (kernel, module, twin, rank of its first operand in a batched call)
    for name, mod, fn, rank in (("k1", k1, "corner_frontend_fused_reference", 3),
                                ("k2", k2, "guided_match_stage1_reference", 3),
                                ("k3", k3, "motion_ba_lm_reference", 2)):
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _name=name, _rank=rank, **kw):
            if a[0].dim() == _rank:  # the batched call, not its per-row twins
                calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, fn, counted)
    before = tree_map(torch.clone, ms.states)
    imgs = torch.from_numpy(np.stack([_u8(seqs[0].frames[4]), _u8(seqs[1].frames[4])]))
    states, info = ms._step(ms.states, imgs, [True, False], None, [2, 2])
    assert calls == {"k1": 1, "k2": 2, "k3": 2}, calls
    assert _equal_states(state_row(states, 1), state_row(before, 1))
    assert not info.is_keyframe[1]
    assert int(states.frame_count[0]) == int(before.frame_count[0]) + 1

    k4_calls = _count_k4(monkeypatch)
    imgs = torch.from_numpy(np.stack([_u8(seqs[0].frames[5]), _u8(seqs[1].frames[5])]))
    states, info = tp.slam_step_multi(states, imgs, [True, True], None, cam=cam,
                                      cfg=tiny_cfg(**FORCED), frontend=ms.frontend)
    assert info.is_keyframe == [True, True]
    assert calls == {"k1": 2, "k2": 4, "k3": 4}, calls
    assert k4_calls == {"batched": [2], "single": 0}, k4_calls


def test_sharded_checkpoint_round_trip(world, tmp_path):
    cam, seqs = world
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], None, tiny_cfg(), device="cpu")
    assert ms.initialize()
    ms.run_batched(max_frames=3, batch=3)
    save_state_sharded(tmp_path / "ckpt", ms.states)
    one = state_row(ms.states, 0)
    template = batched_state(2, F=4, Pcap=256, O=4, K=one.kfs.kp_xy.shape[1], D=128,
                             A=one.arch_rvec.shape[0], device="cpu")
    got = load_state_sharded(tmp_path / "ckpt", template)
    assert _equal_states(got, ms.states)
    only1 = load_state_sharded(tmp_path / "ckpt", tree_map(lambda x: x[:1].clone(), template),
                               rows=[1])
    assert _equal_states(state_row(only1, 0), state_row(ms.states, 1))

