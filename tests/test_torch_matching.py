"""Kernel K2's plain twin and the port's matchers against the JAX package.

Tolerances: the bf16-rounded descriptor products are exact in float32 on
both sides, but the 128-term sums run in another order, so squared
distances agree to 1e-5 and a choice may flip only at a near-tie: the
agreement fractions below say how many must match. Planted exact ties must
go to the lowest index on both sides, with no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import torch

from racing_slam_tpu.ops.matching import match_frames as jax_match_frames
from racing_slam_tpu.ops.matching import match_map_to_frame as jax_map_match
from racing_slam_tpu.ops.matching import unmatched_mask as jax_unmatched
from racing_slam_tpu.ops.pallas.match_kernel import guided_match_stage1
from racing_slam_tpu_torch.ops import matching as tm
from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.ops.kernels.match import guided_match_stage1_reference
from tests.test_map_matching import _setup

torch.set_num_threads(2)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _stage1_inputs(rng, P=128, O=4, D=128, K=300):
    kp_uv = np.stack([rng.uniform(0, 320, K), rng.uniform(0, 240, K)], -1).astype(np.float32)
    kp_desc = _unit(rng.standard_normal((K, D))).astype(np.float32)
    src = rng.integers(0, K, P)
    uv_p = (kp_uv[src] + rng.uniform(-5, 5, (P, 2))).astype(np.float32)
    obs = _unit(kp_desc[src][:, None] + 0.2 * rng.standard_normal((P, O, D))).astype(np.float32)
    obs_valid = rng.uniform(size=(P, O)) < 0.7
    gate = rng.uniform(size=P) < 0.8
    kp_ok = rng.uniform(size=K) < 0.9
    # Planted exact ties: keypoint 2i+1 duplicates 2i, half a pixel away.
    for i in range(0, 40, 2):
        kp_desc[i + 1] = kp_desc[i]
        kp_uv[i + 1] = kp_uv[i] + 0.5
        kp_ok[i] = kp_ok[i + 1] = True
    return uv_p, gate, obs, obs_valid, kp_uv, kp_desc, kp_ok


def test_k2_twin_matches_pallas_interpret(rng):
    args = _stage1_inputs(rng)
    bk, bd = guided_match_stage1_reference(*[torch.from_numpy(a) for a in args], radius_px=20.0)
    jk, jd = guided_match_stage1(*[jnp.asarray(a) for a in args], radius_px=20.0, tile_p=64,
                                 interpret=True)
    bk, bd, jk, jd = bk.numpy(), bd.numpy(), np.asarray(jk), np.asarray(jd)
    same = bk == jk
    assert same.mean() >= 0.99
    np.testing.assert_allclose(bd[same], jd[same], atol=1e-5)
    # Planted ties resolve to the lower (even) index on both sides.
    ties = np.isin(jk, np.arange(0, 40, 2)) & (jd < 1e9)
    assert ties.sum() > 0
    np.testing.assert_array_equal(bk[ties], jk[ties])
    # Nothing passed -> (0, 1e9), as the Pallas kernel's initial values.
    none = jd >= 1e9
    assert none.sum() > 0
    np.testing.assert_array_equal(bk[none], 0)
    np.testing.assert_array_equal(bd[none], 1e9)


def test_map_to_frame_matches_jax(rng):
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = _setup(rng, P=60, K=80, D=32, O=3)
    P, K = X.shape[0], kp_uv.shape[0]
    pt_matched = np.zeros(P, bool)
    pt_matched[:5] = True
    kp_matched = np.zeros(K, bool)
    kp_matched[10:15] = True
    want = jax_map_match(
        cam, jnp.asarray(pose), jnp.asarray(X), jnp.ones(P, bool), jnp.asarray(obs_desc),
        jnp.asarray(obs_valid), jnp.asarray(kp_uv), jnp.asarray(kp_desc), jnp.ones(K, bool),
        jnp.asarray(kp_matched), jnp.asarray(pt_matched), max_distance=0.8, chunk=32,
    )
    got = tm.match_map_to_frame(
        Camera(*cam), torch.from_numpy(pose), torch.from_numpy(X), torch.ones(P, dtype=torch.bool),
        torch.from_numpy(obs_desc).to(torch.bfloat16), torch.from_numpy(obs_valid),
        torch.from_numpy(kp_uv), torch.from_numpy(kp_desc), torch.ones(K, dtype=torch.bool),
        torch.from_numpy(kp_matched), torch.from_numpy(pt_matched), max_distance=0.8,
    )
    wv, gv = np.asarray(want.valid), got.valid.numpy()
    assert (wv == gv).mean() >= 0.97 and wv.sum() > 40
    both = wv & gv
    assert (np.asarray(want.point_idx)[both] == got.point_idx.numpy()[both]).mean() >= 0.97
    np.testing.assert_allclose(got.distance.numpy()[both], np.asarray(want.distance)[both],
                               atol=1e-4)
    assert not gv[10:15].any() and not np.isin(got.point_idx.numpy()[gv], np.arange(5)).any()


def test_match_frames_and_unmatched_mask_match_jax(rng):
    K1, K2, D = 200, 180, 128
    d1 = _unit(rng.standard_normal((K1, D))).astype(np.float32)
    perm = rng.permutation(K1)[:K2]
    d2 = _unit(d1[perm] + 0.25 * rng.standard_normal((K2, D))).astype(np.float32)
    v1 = rng.uniform(size=K1) < 0.9
    v2 = rng.uniform(size=K2) < 0.9
    want = jax_match_frames(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2),
                            0.8)
    got = tm.match_frames(torch.from_numpy(d1), torch.from_numpy(v1), torch.from_numpy(d2),
                          torch.from_numpy(v2), 0.8)
    assert (np.asarray(want.valid) == got.valid.numpy()).mean() >= 0.99
    ok = np.asarray(want.valid) & got.valid.numpy()
    np.testing.assert_array_equal(np.asarray(want.train_idx)[ok], got.train_idx.numpy()[ok])
    np.testing.assert_allclose(got.distance.numpy()[ok], np.asarray(want.distance)[ok], atol=1e-5)
    m1 = rng.uniform(size=K1) < 0.3
    m2 = rng.uniform(size=K2) < 0.3
    np.testing.assert_array_equal(
        tm.unmatched_mask(got, torch.from_numpy(m1), torch.from_numpy(m2)).numpy()[ok],
        np.asarray(jax_unmatched(want, jnp.asarray(m1), jnp.asarray(m2)))[ok],
    )
