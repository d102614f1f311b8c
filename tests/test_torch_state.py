"""The port's world-state functions against racing_slam_tpu/slam/state.py,
plus the JAX<->port state converter.

Integer and mask results must be identical (same stable orders, same
drop-on-out-of-range scatters); float results agree to float32 rounding
(atol 1e-4 px on reprojection errors of a few px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_slam_tpu.slam import state as js
from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.slam import state as ts
from racing_slam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from tests.geometry_fixtures import default_camera

torch.set_num_threads(2)
F, P, O, K, D = 5, 64, 4, 32, 16


def _random_state(rng):
    st = js.SlamState.create(F=F, P=P, O=O, K=K, D=D, A=8)
    kfs = st.kfs._replace(
        rvec=jnp.asarray(rng.normal(0, 0.05, (F, 3)), jnp.float32),
        t=jnp.asarray(rng.normal(0, 0.5, (F, 3)), jnp.float32),
        kp_xy=jnp.asarray(rng.uniform(0, 600, (F, K, 2)), jnp.float32),
        desc=jnp.asarray(rng.normal(size=(F, K, D)), jnp.float32),
        kp_valid=jnp.asarray(rng.uniform(size=(F, K)) < 0.9),
        matches=jnp.asarray(rng.integers(-1, P, (F, K)), jnp.int32),
        valid=jnp.asarray([True, True, True, False, True]),
        frame_index=jnp.asarray([3, 7, 1, -1, 9], jnp.int32),
    )
    m = st.map._replace(
        pos=jnp.asarray(rng.normal(0, 2, (P, 3)) + [0, 0, 8], jnp.float32),
        color=jnp.asarray(rng.uniform(size=P), jnp.float32),
        valid=jnp.asarray(rng.uniform(size=P) < 0.6),
        obs_kf=jnp.asarray(rng.integers(0, F, (P, O)), jnp.int32),
        obs_kp=jnp.asarray(rng.integers(0, K, (P, O)), jnp.int32),
        obs_valid=jnp.asarray(rng.uniform(size=(P, O)) < 0.6),
    )
    return st._replace(kfs=kfs, map=m, num_kf=jnp.int32(4))


def _both(rng):
    jst = _random_state(rng)
    return jst, state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")


def _eq(got, want, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if atol:
        np.testing.assert_allclose(got, want, atol=atol)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype))


def _eq_tree(got, want, atol=0.0):
    for g, w in zip(jax.tree.leaves(state_to_numpy(got)), jax.tree.leaves(want)):
        _eq(g, w, atol)


def test_converter_round_trip_is_exact(rng):
    jst = _random_state(rng)
    jst = jst._replace(obs_desc=jnp.asarray(rng.normal(size=(P, O, D)), jnp.bfloat16))
    back = state_to_numpy(state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu"))
    leaves_b, leaves_j = jax.tree.leaves(back), jax.tree.leaves(jst)
    assert len(leaves_b) == len(leaves_j)
    for b, j in zip(leaves_b, leaves_j):
        np.testing.assert_array_equal(b, np.asarray(j, b.dtype))
    assert back.obs_desc.dtype == np.float32


def test_write_keyframe_and_queries(rng):
    jst, tst = _both(rng)
    feat = (rng.uniform(0, 600, (K, 2)).astype(np.float32),
            rng.normal(size=(K, D)).astype(np.float32), rng.uniform(size=K) < 0.8,
            rng.uniform(size=K).astype(np.float32))
    match = rng.integers(-1, P, K)
    want = js.write_keyframe(jst.kfs, jnp.int32(3), jnp.ones(3), jnp.zeros(3),
                             js.Features(*[jnp.asarray(a) for a in feat]),
                             jnp.asarray(match, jnp.int32), jnp.int32(11))
    got = ts.write_keyframe(tst.kfs, torch.tensor(3), torch.ones(3), torch.zeros(3),
                            ts.Features(*[torch.from_numpy(a) for a in feat]),
                            torch.from_numpy(match), torch.tensor(11))
    _eq_tree(got, want)
    for f in range(F):
        _eq(got.num_matches(torch.tensor(f)), want.num_matches(f))
        _eq(tst.map.observed_by(torch.tensor(f)), jst.map.observed_by(f))
    slots = np.array([1, -1, 4], np.int64)
    _eq(tst.map.observed_by_any(torch.from_numpy(slots)),
        jst.map.observed_by_any(jnp.asarray(slots, jnp.int32)))
    _eq(tst.map.num_points(), jst.map.num_points())
    d, v = tst.map.observation_descriptors(tst.kfs)
    dj, vj = jst.map.observation_descriptors(jst.kfs)
    _eq(d, dj)
    _eq(v, vj)


@pytest.mark.parametrize("budget", [8, 40, 64])
def test_ba_point_selection(rng, budget):
    jst, tst = _both(rng)
    for got, want in ((tst.map.ba_point_selection(torch.tensor(1), budget),
                       jst.map.ba_point_selection(1, budget)),
                      (tst.map.ba_point_selection_mask(tst.map.valid, budget),
                       jst.map.ba_point_selection_mask(jst.map.valid, budget))):
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    _eq(ts.allocate_point_slots(tst.map.valid, 20), js.allocate_point_slots(jst.map.valid, 20))


def test_create_points(rng):
    jst, tst = _both(rng)
    C = K
    pos = rng.normal(size=(C, 3)).astype(np.float32)
    cv = rng.uniform(size=C) < 0.7
    kp_a = rng.permutation(K)
    col = rng.uniform(size=C).astype(np.float32)
    jm, jk, jsl, jcr = js.create_points(jst.map, jnp.asarray(pos), jnp.asarray(cv), jnp.int32(1),
                                        jnp.int32(4), jnp.asarray(kp_a, jnp.int32),
                                        jnp.arange(C, dtype=jnp.int32), jnp.asarray(col), jst.kfs)
    tm, tk, tsl, tcr = ts.create_points(tst.map, torch.from_numpy(pos), torch.from_numpy(cv),
                                        torch.tensor(1), 4, torch.from_numpy(kp_a),
                                        torch.arange(C), torch.from_numpy(col), tst.kfs)
    _eq_tree(tm, jm)
    _eq_tree(tk, jk)
    _eq(tsl, jsl)
    _eq(tcr, jcr)
    assert int(tcr.sum()) > 0


def test_create_points_with_more_candidates_than_slots(rng):
    """C > P (a frame's K keypoints against a smaller map, as the CLI's
    --map-capacity 1024 at K = 2400): the port takes JAX's clamped slots
    and creates the same points."""
    jst, tst = _both(rng)
    C = 3 * P // 2
    pos = rng.normal(size=(C, 3)).astype(np.float32)
    cv = rng.uniform(size=C) < 0.7
    kp = rng.integers(0, K, C)
    col = rng.uniform(size=C).astype(np.float32)
    jm, jk, jsl, jcr = js.create_points(jst.map, jnp.asarray(pos), jnp.asarray(cv), jnp.int32(1),
                                        jnp.int32(4), jnp.asarray(kp, jnp.int32),
                                        jnp.asarray(kp[::-1].copy(), jnp.int32), jnp.asarray(col),
                                        jst.kfs)
    tm, tk, tsl, tcr = ts.create_points(tst.map, torch.from_numpy(pos), torch.from_numpy(cv), 1,
                                        4, torch.from_numpy(kp), torch.from_numpy(kp[::-1].copy()),
                                        torch.from_numpy(col), tst.kfs)
    _eq_tree(tm, jm)
    _eq_tree(tk, jk)
    _eq(tsl, jsl)
    _eq(tcr, jcr)
    assert 0 < int(tcr.sum()) == int((~np.asarray(jst.map.valid)).sum())


@pytest.mark.parametrize("policy", ["replace_oldest", "drop_newest"])
def test_add_associations_and_remove_points(rng, policy):
    jst, tst = _both(rng)
    pid = rng.permutation(P)[:K]
    pid[::5] = -1
    ok = rng.uniform(size=K) < 0.8
    got = ts.add_associations(tst.map, torch.tensor(2), torch.from_numpy(pid), torch.from_numpy(ok),
                              tst.kfs.frame_index, policy=policy)
    want = js.add_associations(jst.map, jnp.int32(2), jnp.asarray(pid, jnp.int32),
                               jnp.asarray(ok), jst.kfs.frame_index, policy=policy)
    _eq_tree(got, want)
    rm = rng.uniform(size=P) < 0.3
    gm, gk = ts.remove_points(got, tst.kfs, torch.from_numpy(rm))
    wm, wk = js.remove_points(want, jst.kfs, jnp.asarray(rm))
    _eq_tree(gm, wm)
    _eq_tree(gk, wk)


def test_reprojection_errors(rng):
    jst, tst = _both(rng)
    jc = default_camera()
    tc = Camera(*jc)
    got = ts.point_reprojection_errors(tc, tst.map, tst.kfs)
    want = js.point_reprojection_errors(jc, jst.map, jst.kfs)
    _eq(got[1], want[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-4)
    sel = rng.permutation(P)[:20]
    sel_ok = rng.uniform(size=20) < 0.8
    got = ts.point_reprojection_errors_sel(tc, tst.map, tst.kfs, torch.from_numpy(sel),
                                           torch.from_numpy(sel_ok))
    want = js.point_reprojection_errors_sel(jc, jst.map, jst.kfs, jnp.asarray(sel, jnp.int32),
                                            jnp.asarray(sel_ok))
    _eq(got[1], want[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        float(ts.keyframe_reprojection_error(tc, tst.map, tst.kfs)),
        float(js.keyframe_reprojection_error(jc, jst.map, jst.kfs)), rtol=1e-5)


def test_set_drop_matches_jax_mode_drop(rng):
    x = rng.normal(size=(10, 3)).astype(np.float32)
    idx = np.array([0, 10, 3, -1, 12, 9])
    vals = rng.normal(size=(6, 3)).astype(np.float32)
    want = jnp.asarray(x).at[jnp.asarray(np.where(idx < 0, 10, idx))].set(jnp.asarray(vals),
                                                                           mode="drop")
    _eq(ts.set_drop(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(vals)), want)


def test_slam_config_matches_jax():
    """The port's SlamConfig has the JAX package's fields, in order, with
    the same defaults."""
    import dataclasses

    from racing_slam_tpu.slam.config import SlamConfig as JaxSlamConfig
    from racing_slam_tpu_torch.slam.config import SlamConfig

    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert spec(SlamConfig) == spec(JaxSlamConfig)
    assert dataclasses.asdict(SlamConfig(map_capacity=1024, local_ba_window=1)) == \
        dataclasses.asdict(JaxSlamConfig(map_capacity=1024, local_ba_window=1))


def test_metrics_and_source_match_jax(rng):
    """ATE after Sim(3) alignment, camera centers and the array source agree
    with the JAX package's host modules (same numpy arithmetic: 1e-12)."""
    from racing_slam_tpu.utils import metrics as jm
    from racing_slam_tpu.utils.video import ArraySource as JaxArraySource
    from racing_slam_tpu_torch.ops import se3
    from racing_slam_tpu_torch.utils import metrics as tm
    from racing_slam_tpu_torch.utils.video import ArraySource

    n = 12
    est = se3.pose_matrix(torch.from_numpy(rng.normal(0, 0.1, (n, 3)).astype(np.float32)),
                          torch.from_numpy(rng.normal(0, 2, (n, 3)).astype(np.float32))).numpy()
    gt = est.copy()
    gt[:, :3, 3] = 1.7 * gt[:, :3, 3] + rng.normal(0, 0.05, (n, 3))
    np.testing.assert_allclose(tm.camera_centers(est), jm.camera_centers(est), atol=1e-12)
    for align in (True, False):
        np.testing.assert_allclose(tm.ate_rmse(est, gt, align), jm.ate_rmse(est, gt, align),
                                   atol=1e-12)
    frames = [rng.uniform(size=(4, 5)).astype(np.float32) for _ in range(3)]
    for a, b in zip(ArraySource(frames), JaxArraySource(frames), strict=True):
        np.testing.assert_array_equal(a, b)


def test_rotation_errors_deg_matches_jax(rng):
    """rotation_errors_deg against the JAX package's on seeded poses (numpy
    on both sides: 1e-9 degrees), with the first frame's error 0."""
    from racing_slam_tpu.utils import metrics as jm
    from racing_slam_tpu_torch.ops import se3
    from racing_slam_tpu_torch.utils import metrics as tm

    n = 20
    gt = se3.pose_matrix(torch.from_numpy(rng.normal(0, 0.3, (n, 3))),
                         torch.from_numpy(rng.normal(0, 2, (n, 3)))).numpy()
    est = gt.copy()
    noise = se3.pose_matrix(torch.from_numpy(rng.normal(0, 0.02, (n, 3))),
                            torch.zeros(n, 3, dtype=torch.float64)).numpy()
    est = noise @ est
    got = tm.rotation_errors_deg(est, gt)
    want = jm.rotation_errors_deg(est, gt)
    assert got.shape == (n,) and got[0] < 1e-5 and got[1:].max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-9)
