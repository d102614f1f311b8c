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
    # The solver's reported cost is the cost of its solution, evaluated with
    # the scalar expansion K4's twin uses (residual_and_jacobians): on this
    # noise-free rig the solved cost is float32 rounding noise (~3e-13),
    # which only the same expansion reproduces to 1e-5.
    include, safe = tba.obs_include(tprob)
    r, _, _ = tba.residual_and_jacobians(
        res.cam_rvec[safe], res.cam_t[safe], res.points[:, None].expand(*safe.shape, 3),
        tprob.obs_uv, tcam.fx, tcam.cx, tcam.cy)
    s = torch.sum(r * r, dim=-1)
    cost = torch.sum(torch.where(include, tba.huber_cost(s, HUBER), torch.zeros_like(s)))
    np.testing.assert_allclose(float(cost), float(res.cost), rtol=1e-5)


def test_structure_ba_stacked_matches_jax_vmap(rng):
    """The port's ops.ba.structure_ba over C = 3 stacked problems (one K4
    twin call; the rows that commit on one lockstep frame) against jax.vmap
    of the JAX package's structure_ba(..., backend="xla") over the same
    stack, as its vmapped commit runs it: three perturbed rigs, free slots
    2, 1 and 2, the third with 20 frozen points; this file's tolerances per
    problem. Each problem's result equals its unstacked call to the bit."""
    import jax

    probs = [_perturbed_rig(rng)[3] for _ in range(3)]
    cam = _perturbed_rig(rng)[0]
    pf = np.ones(probs[2].points.shape[0], bool)
    pf[:20] = False
    probs[2] = probs[2]._replace(point_free=jnp.asarray(pf))
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *probs)
    free = np.array([2, 1, 2])
    ref = jax.vmap(lambda p, f: jba.structure_ba(cam, p, f, backend="xla"))(
        stacked, jnp.asarray(free, jnp.int32))
    tprob = _tprob(stacked)
    res = tba.structure_ba(Camera(*cam), tprob, torch.from_numpy(free))
    assert res.points.shape == tprob.points.shape and res.cost.shape == (3,)
    for c, f in enumerate(free):
        np.testing.assert_allclose(res.cam_rvec[c, f].numpy(), np.asarray(ref.cam_rvec)[c, f],
                                   atol=1e-5)
        np.testing.assert_allclose(res.cam_t[c, f].numpy(), np.asarray(ref.cam_t)[c, f],
                                   atol=1e-4)
        r_cost = float(ref.cost[c])
        assert abs(float(res.cost[c]) - r_cost) <= 0.01 * r_cost + 1e-10, (c, res.cost[c], r_cost)
        err = np.linalg.norm(res.points[c].numpy() - np.asarray(ref.points)[c], axis=-1)
        assert np.median(err) < 1e-4, (c, np.median(err))
        one = tba.structure_ba(Camera(*cam), tba.BAProblem(*[x[c] for x in tprob]),
                               torch.tensor(f))
        assert all(torch.equal(a, b[c]) for a, b in zip(one, res)), c
    np.testing.assert_array_equal(res.points[2, :20].numpy(), np.asarray(probs[2].points)[:20])


# ---------------------------------------------------------------------------
# Schur building blocks, window_ba and full_ba (plain PyTorch on both sides
# of the card; the JAX package has no Pallas kernel here)
# ---------------------------------------------------------------------------


def _tprob(prob):
    return tba.BAProblem(*[T(np.asarray(x)) for x in prob])


def _rig_problem(rng, case):
    """The rigs of tests/test_ba.py:107-200 and :237-282 (noise-free
    observations, perturbed poses and points)."""
    from scipy.spatial.transform import Rotation

    from tests.test_ba import _make_rig, _problem_from_rig

    n_cams = 4 if case.startswith("window") else 3
    cam, poses, X, obs_cam, obs_uv, obs_valid = _make_rig(rng, n_cams=n_cams)
    pert = [p.copy() for p in poses]
    P = len(X)
    cam_free = np.array([False, False, True] + [True] * (n_cams - 3))
    point_free = np.ones(P, bool)
    kw = {}
    Xn = X + rng.normal(0, 0.03, X.shape).astype(np.float32)
    if case == "structure_only":
        cam_free[:] = False
        Xn = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    elif case == "keyframe":
        pert[2][:3, 3] += np.float32([0.06, -0.04, 0.05])
        pert[2][:3, :3] = (Rotation.from_rotvec([0.01, 0.02, -0.01]).as_matrix()
                           @ pert[2][:3, :3]).astype(np.float32)
    elif case == "frozen_points":
        pert[2][:3, 3] += np.float32([0.05, 0.03, -0.04])
        point_free[:] = False
        Xn = X
    elif case == "out_of_problem":
        excl = np.arange(P) >= P // 2
        obs_uv = obs_uv.copy()
        obs_uv[excl] += 500.0
        point_free = ~excl
        kw = dict(point_in_problem=~excl)
        Xn = X
    else:  # window cases: the two newest cameras perturbed
        for i in (2, 3):
            pert[i][:3, 3] += rng.normal(0, 0.04, 3).astype(np.float32)
    prob = _problem_from_rig(cam, pert, Xn, obs_cam, obs_uv, obs_valid, cam_free=cam_free,
                             point_free=point_free, **kw)
    return cam, prob


@pytest.mark.parametrize("frozen", [False, True])
def test_schur_blocks_match_jax(rng, frozen):
    """build_reduced_system, solve_camera_system and back_substitute_points
    against the JAX package's on one rig (camera 2 free; with `frozen`, a
    quarter of the points frozen). Tolerance: float32 sums over the same
    observations in another order, relative 1e-4 of each block's scale."""
    cam, prob = _rig_problem(rng, "keyframe")
    if frozen:
        pf = np.ones(prob.points.shape[0], bool)
        pf[::4] = False
        prob = prob._replace(point_free=jnp.asarray(pf))
    lam = 1e-3
    want, wcost = jba.build_reduced_system(cam, prob, jnp.float32(lam), HUBER)
    got, gcost = tba.build_reduced_system(Camera(*cam), _tprob(prob), torch.tensor(lam), HUBER)
    np.testing.assert_allclose(float(gcost), float(wcost), rtol=1e-5)
    for name in ("S", "g_red", "Hpp_inv", "g_p", "W"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)
    free = np.asarray(prob.cam_free)
    wd = np.asarray(jba.solve_camera_system(want.S, want.g_red, prob.cam_free))
    gd = tba.solve_camera_system(got.S, got.g_red, torch.tensor(free)).numpy()
    np.testing.assert_array_equal(gd[~free], 0.0)
    np.testing.assert_allclose(gd, wd, rtol=1e-3, atol=1e-3 * np.abs(wd).max())
    safe = np.clip(np.asarray(prob.obs_cam), 0, len(free) - 1)
    wp = np.asarray(jba.back_substitute_points(want, jnp.asarray(wd), jnp.asarray(safe)))
    gp = tba.back_substitute_points(got, torch.from_numpy(wd), T(safe).long()).numpy()
    np.testing.assert_allclose(gp, wp, rtol=1e-3, atol=1e-3 * np.abs(wp).max())
    if frozen:
        np.testing.assert_array_equal(gp[::4], 0.0)


def _compare_solves(got, want, rv_tol, t_tol):
    np.testing.assert_allclose(got.cam_rvec.numpy(), np.asarray(want.cam_rvec), atol=rv_tol)
    np.testing.assert_allclose(got.cam_t.numpy(), np.asarray(want.cam_t), atol=t_tol)
    err = np.linalg.norm(got.points.numpy() - np.asarray(want.points), axis=-1)
    assert np.median(err) < 1e-4, np.median(err)
    assert abs(float(got.cost) - float(want.cost)) <= 0.01 * float(want.cost) + 1e-10


@pytest.mark.parametrize("case", ["structure_only", "keyframe", "frozen_points",
                                  "out_of_problem"])
def test_full_ba_matches_jax(rng, case):
    """full_ba on tests/test_ba.py:107-200's rigs against the JAX solver.
    Tolerances (tests/test_ba_kernels.py's): rvec 1e-5, t 1e-4, median
    point difference < 1e-4, cost within 1 %; frozen cameras and points
    bit-identical."""
    cam, prob = _rig_problem(rng, case)
    want = jba.full_ba(cam, prob)
    tprob = _tprob(prob)
    got = tba.full_ba(Camera(*cam), tprob)
    _compare_solves(got, want, 1e-5, 1e-4)
    frozen = ~np.asarray(prob.cam_free)
    np.testing.assert_array_equal(got.cam_t.numpy()[frozen], np.asarray(prob.cam_t)[frozen])
    fixed = ~np.asarray(prob.point_free)
    np.testing.assert_array_equal(got.points.numpy()[fixed], np.asarray(prob.points)[fixed])
    assert int(got.num_residuals) == int(want.num_residuals)


@pytest.mark.parametrize("case", ["window_full_set", "window_partial_set"])
def test_window_ba_matches_jax(rng, case):
    """window_ba with free slots [3, 2, -1] (tests/test_ba.py:237-282)
    against the JAX solver, and, with the same free set, against the port's
    full_ba. Tolerances as test_full_ba_matches_jax; frozen cameras
    bit-identical."""
    cam, prob = _rig_problem(rng, case)
    slots = [3, 2, -1] if case == "window_full_set" else [3, -1, -1, -1]
    want = jba.window_ba(cam, prob, jnp.asarray(slots, jnp.int32))
    tprob = _tprob(prob)
    got = tba.window_ba(Camera(*cam), tprob, torch.tensor(slots))
    _compare_solves(got, want, 1e-5, 1e-4)
    n_frozen = 2 if case == "window_full_set" else 3
    np.testing.assert_array_equal(got.cam_t.numpy()[:n_frozen],
                                  np.asarray(prob.cam_t)[:n_frozen])
    np.testing.assert_array_equal(got.cam_rvec.numpy()[:n_frozen],
                                  np.asarray(prob.cam_rvec)[:n_frozen])
    free = torch.zeros(4, dtype=torch.bool)
    free[[s for s in slots if s >= 0]] = True
    full = tba.full_ba(Camera(*cam), tprob._replace(cam_free=free))
    _compare_solves(got, full, 1e-5, 1e-4)


@pytest.mark.parametrize("case", ["keyframe", "window_full_set"])
def test_matrix_obs_terms_match_jax(rng, case):
    """The window and full solvers' matrix-form observation terms
    (_obs_terms) and residual-only cost (_problem_cost) against the JAX
    package's scalar-expanded ones on the window and full solvers' rigs:
    same values to float32 rounding (rtol 1e-4, atol 1e-6; masks exactly;
    cost rtol 1e-5)."""
    cam, prob = _rig_problem(rng, case)
    tcam, tprob = Camera(*cam), _tprob(prob)
    got, want = tba._obs_terms(tcam, tprob, HUBER), jba._obs_terms(cam, prob, HUBER)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tba._problem_cost(tcam, tprob, HUBER)),
                               float(jba._problem_cost(cam, prob, HUBER)), rtol=1e-5)


@pytest.mark.parametrize("seed", [11, 12])
def test_k3_twin_on_the_path_problem_matches_xla(seed):
    """K3's twin, the oracle the card compares the kernel against, on the
    tracking path's problem (chip_smoke.py check_motion_ba: K = 2400 rows,
    70 % valid, 10 % gross outliers, 0.5 px noise, pixel Huber scale) run
    to the path's max_iters = 10, against the JAX package's XLA motion_ba
    (the same loop, function-tolerance exit and damping): rvec 1e-5, t
    1e-4, cost within 1 %."""
    rng = np.random.default_rng(seed)
    K, cam = 2400, Camera(480.0, 480.0, 320.0, 240.0, 640, 480)
    X = np.stack([rng.uniform(-6, 6, K), rng.uniform(-4, 4, K), rng.uniform(4, 14, K)], -1)
    w = np.array([0.02, -0.05, 0.01])
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    Xc = X @ R.T + [0.3, -0.1, 0.2]
    uv = np.stack([480.0 * Xc[:, 0] / Xc[:, 2] + 320.0, 480.0 * Xc[:, 1] / Xc[:, 2] + 240.0], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    uv[: K // 10] += rng.uniform(40, 120, (K // 10, 2))
    valid = rng.uniform(size=K) < 0.7
    X, uv = X.astype(np.float32), uv.astype(np.float32)
    rv0 = (w + [0.01, -0.01, 0.005]).astype(np.float32)
    t0 = np.array([0.35, -0.14, 0.26], np.float32)
    huber = float(np.sqrt(5.991)) / cam.fx
    out = _motion_twin(cam, rv0, t0, uv, X, valid, huber)
    ref = jba.motion_ba(cam, jnp.asarray(rv0), jnp.asarray(t0), jnp.asarray(uv), jnp.asarray(X),
                        jnp.asarray(valid), max_iters=10, huber_delta=huber, backend="xla")
    np.testing.assert_allclose(out[:3], np.asarray(ref.rvec), atol=1e-5)
    np.testing.assert_allclose(out[3:6], np.asarray(ref.t), atol=1e-4)
    assert abs(out[6] - float(ref.cost)) <= 0.01 * float(ref.cost) + 1e-10
    assert 1 <= out[7] <= 10


def _last_move(solve) -> int:
    """The last LM iteration that moved a solve: the least max_iters whose
    result equals the solve's at MAX_ITERS, to the bit (a problem frozen by
    the function tolerance or by rejected steps moves no more)."""
    final = solve(tba.MAX_ITERS)
    return next(k for k in range(tba.MAX_ITERS + 1)
                if all(torch.equal(a, b) for a, b in zip(solve(k), final)))


def _stacked_against_single_and_jax_vmap(probs, solve, jax_solve, *args):
    """`solve` over the stacked problems (and the stacked `args`) against
    its call on each problem alone, to the bit, and against jax.vmap of
    `jax_solve` over the same numpy stack within test_window_ba_matches_jax's
    tolerances; returns each problem's last moving iteration."""
    import jax

    stacked = jax.tree.map(lambda *x: jnp.stack(x), *probs)
    want = jax.vmap(jax_solve)(stacked, *[jnp.asarray(a) for a in args])
    tprob = _tprob(stacked)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    got = solve(tprob, *targs, tba.MAX_ITERS)
    assert got.cost.shape == (len(probs),) and got.points.shape == tprob.points.shape
    moves = []
    for c in range(len(probs)):
        one = tba.BAProblem(*[x[c] for x in tprob])
        single = solve(one, *[a[c] for a in targs], tba.MAX_ITERS)
        assert all(torch.equal(a[c], b) for a, b in zip(got, single)), c
        _compare_solves(tba.BAResult(*[x[c] for x in got]),
                        jax.tree.map(lambda x, c=c: x[c], want), 1e-5, 1e-4)
        assert int(got.num_residuals[c]) == int(want.num_residuals[c])
        moves.append(_last_move(lambda k, c=c, one=one: solve(one, *[a[c] for a in targs], k)))
    return moves


def test_window_ba_stacked_equals_single_calls_and_jax_vmap(rng):
    """window_ba over C = 3 stacked problems (the rows that commit on one
    lockstep frame): three rigs with their own data, W = 4 free slots
    [3, 2, -1, -1], [3, -1, -1, -1] and [2, 3, -1, -1]. Each problem equals
    its call alone to the bit, and jax.vmap of the JAX package's window_ba
    over the same stack within test_window_ba_matches_jax's tolerances;
    the problems stop moving on different iterations (each freezes on its
    own, as it does alone)."""
    made = [_rig_problem(rng, case)
            for case in ("window_full_set", "window_partial_set", "window_full_set")]
    cam = made[0][0]
    slots = np.array([[3, 2, -1, -1], [3, -1, -1, -1], [2, 3, -1, -1]], np.int32)
    moves = _stacked_against_single_and_jax_vmap(
        [p for _, p in made], lambda p, s, k: tba.window_ba(Camera(*cam), p, s, max_iters=k),
        lambda p, s: jba.window_ba(cam, p, s), slots)
    assert len(set(moves)) > 1, moves


def test_full_ba_stacked_equals_single_calls_and_jax_vmap(rng):
    """full_ba over B = 3 stacked problems (a refinement of three rows):
    the keyframe, frozen-point and out-of-problem rigs, each with its own
    free cameras and points. Each problem equals its call alone to the
    bit, and jax.vmap of the JAX package's full_ba within
    test_full_ba_matches_jax's tolerances; the problems stop moving on
    different iterations."""
    made = [_rig_problem(rng, case) for case in ("keyframe", "frozen_points", "out_of_problem")]
    cam = made[0][0]
    moves = _stacked_against_single_and_jax_vmap(
        [p for _, p in made], lambda p, k: tba.full_ba(Camera(*cam), p, max_iters=k),
        lambda p: jba.full_ba(cam, p))
    assert len(set(moves)) > 1, moves
