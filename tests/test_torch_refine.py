"""The port's refinement helpers (racing_slam_tpu_torch/parallel/refine.py)
against the JAX package's, on a hand-built state with known ground truth
(tests/test_refine.py's `_gt_state`) converted with
utils/convert.state_from_numpy.

Tolerances: building the problems and writing back are gathers, scatters and
4x4 pose products, so their outputs agree to float32 rounding (atol 1e-6;
index and mask outputs exactly). The refinement solve itself (full_ba, 15
iterations) holds tests/test_refine.py's ground-truth bounds (rvec 2e-4,
t 6e-4, points 5e-3) and agrees with the JAX solve to rvec 1e-5, t 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_slam_tpu.ops.ba import BAResult as JaxBAResult
from racing_slam_tpu.ops.ba import full_ba as jax_full_ba
from racing_slam_tpu.parallel import refine as jr
from racing_slam_tpu_torch.ops.ba import BAResult, full_ba
from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.parallel import refine as tr
from racing_slam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from tests.test_refine import CAM, _gt_state

torch.set_num_threads(2)
TCAM = Camera(*CAM)


def _both(state):
    return state, state_from_numpy(jax.tree.map(np.asarray, state))


@pytest.mark.parametrize("valid,fidx", [
    ([True, True, True, False], [7, 2, 5, 0]),
    ([True, False, True, True], [3, 1, 3, 9]),  # a tie in frame index: first slot wins
    ([False, False, False, False], [0, 1, 2, 3]),
])
def test_gauge_anchor_mask_matches_jax(valid, fidx):
    want = np.asarray(jr.gauge_anchor_mask(jnp.asarray(valid), jnp.asarray(fidx, jnp.int32)))
    got = tr.gauge_anchor_mask(torch.tensor(valid), torch.tensor(fidx)).numpy()
    np.testing.assert_array_equal(got, want)


def _assert_problems_equal(got, want):
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if g.dtype == np.bool_ or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("budget", [0, 40])
def test_global_problems_match_jax(rng, budget):
    jst, tst = _both(_gt_state(rng, noise=5e-3)[0])
    # Drop a few points and an observation so the masks matter.
    m = jst.map
    valid = np.asarray(m.valid).copy()
    valid[::7] = False
    obs_valid = np.asarray(m.obs_valid).copy()
    obs_valid[::5, 1] = False
    jst = jst._replace(map=m._replace(valid=jnp.asarray(valid), obs_valid=jnp.asarray(obs_valid)))
    tst = state_from_numpy(jax.tree.map(np.asarray, jst))
    if budget:
        want, wsel, wok = jr.build_global_problem_compact(jst, budget)
        got, gsel, gok = tr.build_global_problem_compact(tst, budget)
        np.testing.assert_array_equal(gsel.numpy(), np.asarray(wsel))
        np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    else:
        want, got = jr.build_global_problem(jst), tr.build_global_problem(tst)
    _assert_problems_equal(got, want)


@pytest.mark.parametrize("compact", [False, True])
def test_refinement_recovers_ground_truth_like_jax(rng, compact):
    """build -> full_ba -> apply on both sides (tests/test_refine.py:101-118)."""
    jst, gt_r, gt_t, gt_X = _gt_state(rng, noise=5e-3)
    tst = state_from_numpy(jax.tree.map(np.asarray, jst))
    P = gt_X.shape[0]
    if compact:
        jprob, jsel, jok = jr.build_global_problem_compact(jst, P)
        tprob, tsel, tok = tr.build_global_problem_compact(tst, P)
    else:
        jprob, tprob = jr.build_global_problem(jst), tr.build_global_problem(tst)
    jres = jax_full_ba(CAM, jprob, max_iters=15)
    tres = full_ba(TCAM, tprob, max_iters=15)
    if compact:
        want = jr.apply_refinement_compact(jst, jres, jsel, jok)
        got = state_to_numpy(tr.apply_refinement_compact(tst, tres, tsel, tok))
    else:
        want = jr.apply_refinement(jst, jres)
        got = state_to_numpy(tr.apply_refinement(tst, tres))
    np.testing.assert_allclose(got.kfs.rvec, gt_r, atol=2e-4)
    np.testing.assert_allclose(got.kfs.t, gt_t, atol=6e-4)
    np.testing.assert_allclose(got.map.pos, gt_X, atol=5e-3)
    np.testing.assert_allclose(got.kfs.rvec, np.asarray(want.kfs.rvec), atol=1e-5)
    np.testing.assert_allclose(got.kfs.t, np.asarray(want.kfs.t), atol=1e-4)
    for name in ("last_rvec", "prev_rvec"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)), atol=1e-5)
    for name in ("last_t", "prev_t"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)), atol=1e-4)
    # The last pose (keyframe F-1's perturbed pose) took the keyframe's correction.
    np.testing.assert_allclose(got.last_t, got.kfs.t[-1], atol=1e-5)


def test_apply_refinement_matches_jax_on_given_solution(rng):
    """The write-back alone, from one solution handed to both sides: poses,
    points and the re-anchored tracking poses to float32 rounding."""
    jst, gt_r, gt_t, gt_X = _gt_state(rng, noise=5e-3)
    jst = jst._replace(prev_rvec=jst.last_rvec + 0.01, prev_t=jst.last_t - 0.05)
    tst = state_from_numpy(jax.tree.map(np.asarray, jst))
    jres = JaxBAResult(cam_rvec=jnp.asarray(gt_r), cam_t=jnp.asarray(gt_t),
                      points=jnp.asarray(gt_X), cost=jnp.float32(0.0),
                      num_residuals=jnp.int32(0))
    tres = BAResult(*[torch.from_numpy(np.array(x)) for x in jres])
    want = jr.apply_refinement(jst, jres)
    got = state_to_numpy(tr.apply_refinement(tst, tres))
    for name in ("last_rvec", "last_t", "prev_rvec", "prev_t"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)), atol=1e-6)
    np.testing.assert_array_equal(got.kfs.t, gt_t)
    np.testing.assert_array_equal(got.map.pos, gt_X)
