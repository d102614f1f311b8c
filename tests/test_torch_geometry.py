"""The port's geometry (se3, camera, triangulation, essential, ransac)
against the JAX package on the same numpy inputs.

Tolerances: both sides compute in float32 with the same formulas, so
elementwise results agree to float32 rounding (atol 1e-5 on O(1) values,
1e-3 px on pixel coordinates of magnitude ~500). The 8-point SVD/eigen
signs are arbitrary, so E is compared up to sign and scale; RANSAC draws
cannot be reproduced across frameworks, so it is held to the ground truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from racing_slam_tpu.ops import camera as jcam
from racing_slam_tpu.ops import essential as jess
from racing_slam_tpu.ops import se3 as jse3
from racing_slam_tpu.ops import triangulation as jtri
from racing_slam_tpu_torch.ops import camera as tcam
from racing_slam_tpu_torch.ops import essential as tess
from racing_slam_tpu_torch.ops import ransac as trans
from racing_slam_tpu_torch.ops import se3 as tse3
from racing_slam_tpu_torch.ops import triangulation as ttri
from tests.geometry_fixtures import default_camera, project_np, random_pose, synthetic_scene

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def _rvecs(rng, n=64):
    # Mixed magnitudes: tiny (Taylor branch), ordinary, and near pi.
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mags = np.concatenate([np.full(8, 1e-6), rng.uniform(0.01, 2.5, n - 16), np.full(8, 3.1)])
    return (v * mags[:, None].astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("fn", ["hat", "exp_so3", "log_so3", "pose_matrix", "inverse"])
def test_se3_matches_jax(rng, fn):
    rv = _rvecs(rng)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    if fn == "hat":
        got, want = tse3.hat(T(rv)), jse3.hat(jnp.asarray(rv))
    elif fn == "exp_so3":
        got, want = tse3.exp_so3(T(rv)), jse3.exp_so3(jnp.asarray(rv))
    elif fn == "log_so3":
        R = Rotation.from_rotvec(rv).as_matrix().astype(np.float32)
        got, want = tse3.log_so3(T(R)), jse3.log_so3(jnp.asarray(R))
    elif fn == "pose_matrix":
        got, want = tse3.pose_matrix(T(rv), T(t)), jse3.pose_matrix(jnp.asarray(rv), jnp.asarray(t))
    else:
        Tm = np.asarray(jse3.pose_matrix(jnp.asarray(rv), jnp.asarray(t)))
        got, want = tse3.inverse(T(Tm)), jse3.inverse(jnp.asarray(Tm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_se3_roundtrip_compose_transform(rng):
    rv = _rvecs(rng)[8:-8]
    t = rng.normal(size=(len(rv), 3)).astype(np.float32)
    Tm = tse3.pose_matrix(T(rv), T(t))
    rv2, t2 = tse3.rt_from_matrix(Tm)
    np.testing.assert_allclose(rv2.numpy(), rv, atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), t, atol=0)
    ident = tse3.compose(Tm, tse3.inverse(Tm)).numpy()
    np.testing.assert_allclose(ident, np.broadcast_to(np.eye(4), ident.shape), atol=1e-5)
    X = rng.normal(size=(len(rv), 5, 3)).astype(np.float32)
    got = tse3.transform_points(Tm, T(X)).numpy()
    want = np.asarray(jse3.transform_points(jnp.asarray(Tm.numpy()), jnp.asarray(X)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    c = tse3.camera_center(Tm).numpy()
    np.testing.assert_allclose(c, np.asarray(jse3.camera_center(jnp.asarray(Tm.numpy()))),
                               atol=1e-5)


def test_camera_matches_jax(rng):
    jc = default_camera()
    tc = tcam.Camera(*jc)
    pose = random_pose(rng)
    X = synthetic_scene(rng, 100)
    uv_t, z_t = tcam.project_with_depth(tc, T(pose), T(X))
    uv_j, z_j = jcam.project_with_depth(jc, jnp.asarray(pose), jnp.asarray(X))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=1e-3)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5)
    np.testing.assert_allclose(uv_t.numpy(), project_np(jc, pose, X), atol=1e-3)
    np.testing.assert_allclose(tcam.project(tc, T(pose), T(X)).numpy(), uv_t.numpy(), atol=0)
    np.testing.assert_array_equal(tcam.is_in_image(tc, uv_t).numpy(),
                                  np.asarray(jcam.is_in_image(jc, uv_j)))
    np.testing.assert_allclose(tcam.normalize_pixels(tc, uv_t).numpy(),
                               np.asarray(jcam.normalize_pixels(jc, uv_j)), atol=1e-5)
    np.testing.assert_allclose(tcam.projection_matrix(tc, T(pose)).numpy(),
                               np.asarray(jcam.projection_matrix(jc, jnp.asarray(pose))),
                               atol=1e-3)


def _two_view(rng, n=120, noise=0.0):
    jc = default_camera()
    pose2 = random_pose(rng, max_angle=0.1, max_trans=0.5)
    pose2[:3, 3] += np.float32([0.6, 0.0, 0.0])
    X = synthetic_scene(rng, n)
    uv1 = project_np(jc, np.eye(4, dtype=np.float32), X)
    uv2 = project_np(jc, pose2, X)
    if noise:
        uv1 = uv1 + rng.normal(0, noise, uv1.shape).astype(np.float32)
        uv2 = uv2 + rng.normal(0, noise, uv2.shape).astype(np.float32)
    return jc, pose2, X, uv1, uv2


def test_triangulation_matches_jax(rng):
    jc, pose2, X, uv1, uv2 = _two_view(rng, noise=0.3)
    mask = rng.uniform(size=len(X)) < 0.9
    eye = np.eye(4, dtype=np.float32)
    got = ttri.triangulate_points(tcam.Camera(*jc), T(eye), T(pose2), T(uv1), T(uv2),
                                  mask=T(mask))
    want = jtri.triangulate_points(jc, jnp.asarray(eye), jnp.asarray(pose2), jnp.asarray(uv1),
                                   jnp.asarray(uv2), mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    # The closed-form DLT normal equations square the condition number of
    # the 4x3 system, so float32 rounding differences in the projection
    # matrices grow to ~3e-4 relative in the points.
    np.testing.assert_allclose(got.points.numpy()[v], np.asarray(want.points)[v], rtol=1e-3,
                               atol=1e-3)
    assert v.sum() > 80


def _unit_sign(E):
    E = E / np.linalg.norm(E)
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


def test_essential_matches_jax_up_to_sign_and_scale(rng):
    jc, pose2, X, uv1, uv2 = _two_view(rng)
    x1 = np.asarray(jcam.normalize_pixels(jc, jnp.asarray(uv1)))
    x2 = np.asarray(jcam.normalize_pixels(jc, jnp.asarray(uv2)))
    w = (rng.uniform(size=len(x1)) < 0.8).astype(np.float32)
    Et = tess.eight_point(T(x1), T(x2), T(w)).numpy()
    Ej = np.asarray(jess.eight_point(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    # Both solve the 9x9 normal system A^T A (condition number squared) with
    # a float32 eigensolver, LAPACK's against XLA's: ~2e-4 apart.
    np.testing.assert_allclose(_unit_sign(Et), _unit_sign(Ej), atol=1e-3)
    s_t = tess.sampson_error_sq(T(Et), T(x1), T(x2)).numpy()
    s_j = np.asarray(jess.sampson_error_sq(jnp.asarray(Et), jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_allclose(s_t, s_j, atol=1e-10, rtol=1e-4)
    # The true (R, t) is among the four decompositions.
    Rs, ts = tess.decompose(T(Et))
    t_true = pose2[:3, 3] / np.linalg.norm(pose2[:3, 3])
    ok = [np.allclose(Rs[i].numpy(), pose2[:3, :3], atol=1e-3)
          and np.allclose(ts[i].numpy(), t_true, atol=1e-3) for i in range(4)]
    assert any(ok)


def test_ransac_on_fixed_uniforms_recovers_pose(rng):
    """Fixed [H, N] uniforms (the port takes them as an argument), 40 %
    outliers: the pose is held to the ground truth (direction of t)."""
    jc, pose2, X, uv1, uv2 = _two_view(rng, n=200, noise=0.2)
    uv2 = uv2.copy()
    out = rng.uniform(size=len(uv2)) < 0.4
    uv2[out] = rng.uniform(0, 480, (out.sum(), 2)).astype(np.float32)
    uniforms = rng.uniform(size=(512, len(uv1))).astype(np.float32)
    est = trans.estimate_relative_pose(tcam.Camera(*jc), T(uv1), T(uv2),
                                       torch.ones(len(uv1), dtype=torch.bool),
                                       uniforms=T(uniforms), threshold_px=1.0)
    pose = est.pose.numpy()
    # The JAX estimate on the same matches (its own PRNG draws) sets the band.
    import jax

    from racing_slam_tpu.ops.ransac import estimate_relative_pose as jax_estimate

    ref = np.asarray(jax_estimate(jc, jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(len(uv1), bool),
                                  jax.random.PRNGKey(0), threshold_px=1.0).pose)

    def rot_err(R):
        return Rotation.from_matrix(R @ pose2[:3, :3].T).magnitude()

    t_true = pose2[:3, 3] / np.linalg.norm(pose2[:3, 3])

    def t_err(P):
        return np.arccos(np.clip(P[:3, 3] @ t_true, -1.0, 1.0))

    assert rot_err(pose[:3, :3]) <= max(2 * rot_err(ref[:3, :3]), 1e-2)
    assert t_err(pose) <= max(2 * t_err(ref), 0.05)
    inl = est.inliers.numpy()
    assert (inl & out).sum() <= 2 and inl[~out].mean() > 0.3


def test_ransac_sampling_is_uniform_over_valid_rows(rng):
    uniforms = T(rng.uniform(size=(2000, 50)).astype(np.float32))
    mask = torch.zeros(50, dtype=torch.bool)
    mask[10:30] = True
    idx = trans.sample_minimal_sets(uniforms, mask).numpy()
    assert ((idx >= 10) & (idx < 30)).all()
    assert all(len(set(r)) == 8 for r in idx)
    counts = np.bincount(idx.ravel(), minlength=50)[10:30]
    assert counts.min() > 0.8 * counts.mean()
