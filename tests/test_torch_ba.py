"""Kernels K3 and K4: their plain twins (and the port's ops.ba solvers)
against the JAX package's XLA solvers and Pallas kernels (interpret mode).

Tolerances are tests/test_ba_kernels.py's for the same cases: rvec atol
1e-5, t atol 1e-4, cost within 1 % of the reference, median point
difference < 1e-4 (float32 reductions in another order; both sides stop on
the same function-tolerance rule).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_slam_tpu.ops import ba as jba
from racing_slam_tpu.ops.pallas.structure_ba_kernel import (
    pack_structure_problem,
    structure_ba_planes,
    unpack_points,
)
from racing_slam_tpu_torch.ops import ba as tba
from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.ops.kernels.motion_ba import motion_ba_lm_reference
from racing_slam_tpu_torch.ops.kernels.structure_ba import structure_ba_lm_reference
from tests.test_ba_kernels import _perturbed_rig, _problem, _run_pallas_motion

torch.set_num_threads(2)
HUBER = float(np.sqrt(5.991))


def T(a):
    return torch.from_numpy(np.array(a))


def test_ba_building_blocks_match_jax(rng):
    n = 50
    rv = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    rv[:5] *= 1e-5  # Taylor branch
    tt = rng.normal(size=(n, 3)).astype(np.float32)
    X = (rng.normal(size=(n, 3)) + [0, 0, 6]).astype(np.float32)
    uv = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    got = tba.residual_and_jacobians(T(rv), T(tt), T(X), T(uv), 500.0, 320.0, 240.0)
    want = jba.residual_and_jacobians(jnp.asarray(rv), jnp.asarray(tt), jnp.asarray(X),
                                      jnp.asarray(uv), 500.0, 320.0, 240.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tba.right_jacobian_so3(T(rv)).numpy(),
                               np.asarray(jba.right_jacobian_so3(jnp.asarray(rv))), atol=1e-6)
    A = rng.normal(size=(n, 6, 6)).astype(np.float32)
    H = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    g = rng.normal(size=(n, 6)).astype(np.float32)
    np.testing.assert_allclose(tba.solve6_spd(T(H), T(g)).numpy(),
                               np.linalg.solve(H, g[..., None])[..., 0], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tba.inv3x3(T(H[:, :3, :3])).numpy(),
                               np.asarray(jba.inv3x3(jnp.asarray(H[:, :3, :3]))), rtol=1e-5,
                               atol=1e-6)
    s = rng.uniform(0, 10, 100).astype(np.float32)
    for fn in ("huber_weight", "huber_cost"):
        np.testing.assert_allclose(getattr(tba, fn)(T(s), 2.0).numpy(),
                                   np.asarray(getattr(jba, fn)(jnp.asarray(s), 2.0)), rtol=1e-6)


def _motion_twin(cam, rv0, t0, uv, X, valid, huber=HUBER):
    return motion_ba_lm_reference(
        T(np.concatenate([rv0, t0]).astype(np.float32)), T(uv), T(X), T(valid),
        fx=cam.fx, cx=cam.cx, cy=cam.cy, max_iters=10, huber_delta=huber,
    ).numpy()


@pytest.mark.parametrize("case", ["clean", "huber_outliers", "masked", "all_invalid"])
def test_k3_twin_matches_xla_and_pallas(rng, case):
    outliers = 15 if case == "huber_outliers" else 0
    cam, T_gt, X, uv, rv0, t0 = _problem(rng, n=150, outliers=outliers)
    valid = np.ones(len(X), bool)
    if case == "masked":
        valid[:40] = False
    if case == "all_invalid":
        valid[:] = False
    huber = 2.45 / cam.fx if case == "huber_outliers" else HUBER
    out = _motion_twin(cam, rv0, t0, uv, X, valid, huber)
    ref = jba.motion_ba(cam, jnp.asarray(rv0), jnp.asarray(t0), jnp.asarray(uv), jnp.asarray(X),
                        jnp.asarray(valid), huber_delta=huber, backend="xla")
    pal = np.asarray(_run_pallas_motion(cam, rv0, t0, uv, X, valid, huber_delta=huber))
    if case == "all_invalid":
        np.testing.assert_array_equal(out[:3], rv0)
        np.testing.assert_array_equal(out[3:6], t0)
        return
    for r_rv, r_t, r_cost in ((np.asarray(ref.rvec), np.asarray(ref.t), float(ref.cost)),
                              (pal[:3], pal[3:6], float(pal[6]))):
        np.testing.assert_allclose(out[:3], r_rv, atol=1e-5)
        np.testing.assert_allclose(out[3:6], r_t, atol=1e-4)
        assert abs(out[6] - r_cost) <= 0.01 * r_cost + 1e-10, (out[6], r_cost)
    # The port's ops.ba.motion_ba routes CPU tensors to the twin.
    res = tba.motion_ba(Camera(*cam), T(rv0), T(t0), T(uv), T(X), T(valid), huber_delta=huber)
    np.testing.assert_array_equal(torch.cat([res.rvec, res.t]).numpy(), out[:6])


def _structure_inputs(prob):
    include = (np.asarray(prob.obs_valid)
               & np.asarray(prob.cam_in_problem)[np.asarray(prob.obs_cam)]
               & np.asarray(prob.point_in_problem)[:, None])
    return (T(prob.cam_rvec), T(prob.cam_t), T(prob.points),
            T(np.asarray(prob.obs_cam).astype(np.int64)), T(prob.obs_uv), T(include),
            T(prob.point_free))


@pytest.mark.parametrize("frozen", [0, 20])
def test_k4_twin_matches_xla_and_pallas(rng, frozen):
    cam, poses, X, prob = _perturbed_rig(rng)
    if frozen:
        pf = np.ones(len(X), bool)
        pf[:frozen] = False
        prob = prob._replace(point_free=jnp.asarray(pf))
    out, pts = structure_ba_lm_reference(
        *_structure_inputs(prob), torch.tensor(2), fx=cam.fx, cx=cam.cx, cy=cam.cy,
        max_iters=10, huber_delta=HUBER,
    )
    out, pts = out.numpy(), pts.numpy()
    ref = jba.structure_ba(cam, prob, jnp.int32(2), backend="xla")
    pose0, obs, pts0, _ = pack_structure_problem(cam, prob, jnp.int32(2))
    pal_pose, pal_pts = structure_ba_planes(pose0, obs, pts0, prob.obs_cam.shape[1], 10, HUBER,
                                            1e-6, interpret=True)
    refs = (
        (np.asarray(ref.cam_rvec)[2], np.asarray(ref.cam_t)[2], float(ref.cost),
         np.asarray(ref.points)),
        (np.asarray(pal_pose[:3]), np.asarray(pal_pose[3:6]), float(pal_pose[6]),
         np.asarray(unpack_points(pal_pts, len(X)))),
    )
    for r_rv, r_t, r_cost, r_pts in refs:
        np.testing.assert_allclose(out[:3], r_rv, atol=1e-5)
        np.testing.assert_allclose(out[3:6], r_t, atol=1e-4)
        assert abs(out[6] - r_cost) <= 0.01 * r_cost + 1e-10, (out[6], r_cost)
        assert np.median(np.linalg.norm(pts - r_pts, axis=-1)) < 1e-4
    if frozen:
        np.testing.assert_array_equal(pts[:frozen], np.asarray(prob.points)[:frozen])
    # Through the port's ops.ba.structure_ba: full camera arrays, only the
    # free slot moved.
    tprob = tba.BAProblem(*[T(np.asarray(x)) for x in prob])
    res = tba.structure_ba(Camera(*cam), tprob, torch.tensor(2))
    np.testing.assert_array_equal(res.cam_t.numpy()[:2], np.asarray(prob.cam_t)[:2])
    np.testing.assert_array_equal(res.cam_rvec.numpy()[2], out[:3])
    np.testing.assert_array_equal(res.points.numpy(), pts)
    # The per-observation terms and the problem cost against the JAX
    # package's; the solver's reported cost is the cost of its solution.
    tcam = Camera(*cam)
    got, want = tba._obs_terms(tcam, tprob, HUBER), jba._obs_terms(cam, prob, HUBER)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tba._problem_cost(tcam, tprob, HUBER)),
                               float(jba._problem_cost(cam, prob, HUBER)), rtol=1e-5)
    solved = tprob._replace(cam_rvec=res.cam_rvec, cam_t=res.cam_t, points=res.points)
    np.testing.assert_allclose(float(tba._problem_cost(tcam, solved, HUBER)), float(res.cost),
                               rtol=1e-5)
