"""Kernel K2's plain twin and the port's matchers against the JAX package.

Tolerances: the bf16-rounded descriptor products are exact in float32 on
both sides, but the 128-term sums run in another order, so squared
distances agree to 1e-5 and a choice may flip only at a near-tie: the
agreement fractions below say how many must match. Planted exact ties must
go to the lowest index on both sides, with no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_slam_tpu.ops.matching import match_frames as jax_match_frames
from racing_slam_tpu.ops.matching import match_map_to_frame as jax_map_match
from racing_slam_tpu.ops.matching import unmatched_mask as jax_unmatched
from racing_slam_tpu.ops.pallas.match_kernel import (
    guided_match_stage1,
    guided_match_stage1_banded,
)
from racing_slam_tpu_torch.ops import matching as tm
from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.ops.kernels.match import guided_match_stage1_reference
from racing_slam_tpu_torch.ops.kernels.match_banded import guided_match_stage1_banded_reference
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


# ---------------------------------------------------------------------------
# The scale path: kernel K5's twin and the banded matcher
# ---------------------------------------------------------------------------


def _banded_inputs(rng, P=256, O=4, D=64, K=512, tile_p=64, tile_k=128, band=2):
    """Sorted inputs as the banded matcher hands them to K5: points gated
    first by ascending y (the last tile ungated), keypoints by ascending y,
    each point tile's band chosen around its y-range, with planted exact
    ties (keypoint 2i+1 duplicates 2i, half a pixel away)."""
    uv_p, gate, obs, obs_valid, kp_uv, kp_desc, kp_ok = _stage1_inputs(rng, P, O, D, K)
    gate[:] = True
    gate[-tile_p:] = False  # one inactive tile
    kp_order = np.argsort(np.where(kp_ok, kp_uv[:, 1], 1e8), kind="stable")
    kp_uv, kp_desc, kp_ok = kp_uv[kp_order], kp_desc[kp_order], kp_ok[kp_order]
    p_order = np.argsort(np.where(gate, uv_p[:, 1], 1e8), kind="stable")
    uv_p, gate, obs, obs_valid = uv_p[p_order], gate[p_order], obs[p_order], obs_valid[p_order]
    n_k = K // tile_k
    mid = np.searchsorted(np.where(kp_ok, kp_uv[:, 1], 1e8),
                          uv_p[:, 1].reshape(-1, tile_p).mean(1)) // tile_k
    starts = np.clip(mid - band // 2, 0, n_k - band).astype(np.int32)
    n_act = np.int32(-(-gate.sum() // tile_p))
    return (uv_p, gate, obs, obs_valid, kp_uv, kp_desc, kp_ok, starts, n_act)


def test_k5_twin_matches_pallas_interpret(rng):
    """Tolerance as K2's (module docstring): >= 99 % of the points pick the
    same sorted keypoint, distances to 1e-5 where they do; planted ties to
    the lower sorted index, inactive tiles and ungated points (0, 1e9)
    exactly."""
    tiles = dict(tile_p=64, tile_k=128, band_tiles=2)
    args = _banded_inputs(rng)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    targs.insert(4, torch.arange(len(args[0]), dtype=torch.int32))  # the rows as they are
    bk, bd = guided_match_stage1_banded_reference(*targs, radius_px=20.0, **tiles)
    jk, jd = guided_match_stage1_banded(*[jnp.asarray(a) for a in args], radius_px=20.0,
                                        interpret=True, **tiles)
    bk, bd, jk, jd = bk.numpy(), bd.numpy(), np.asarray(jk), np.asarray(jd)
    assert (jd < 1e9).sum() > 100
    same = bk == jk
    assert same.mean() >= 0.99
    np.testing.assert_allclose(bd[same], jd[same], atol=1e-5)
    kp_desc = args[5]
    dup = np.nonzero((kp_desc[1:] == kp_desc[:-1]).all(-1))[0]  # lower index of each tie
    ties = np.isin(jk, dup) & (jd < 1e9)
    assert ties.sum() > 0
    np.testing.assert_array_equal(bk[ties], jk[ties])
    none = jd >= 1e9
    assert none[-64:].all()
    np.testing.assert_array_equal(bk[none], 0)
    np.testing.assert_array_equal(bd[none], 1e9)


def test_k5_twin_reads_rows_through_p_sel(rng):
    """K5's contract reads the point rows through p_sel: on unsorted rows
    and a p_sel that sorts them and pads them past P (the padding rows
    ungated), the twin equals the twin on the rows gathered by hand, bit for
    bit (the same arithmetic on the same values)."""
    tiles = dict(radius_px=20.0, tile_p=64, tile_k=128, band_tiles=2)
    args = _banded_inputs(rng)
    uv_p, gate, obs, obs_valid = args[:4]
    P, G = len(uv_p) - 20, len(uv_p)  # 20 padding rows
    perm = rng.permutation(G)
    rows = np.argsort(perm)  # row g of the sorted order sits in slot rows[g] ...
    p_sel = rows.astype(np.int32)
    pad = p_sel >= P
    gate = gate.copy()
    gate[pad] = False  # ... and the sorted rows that land in padding are ungated
    slots = [np.zeros((P,) + a.shape[1:], a.dtype) for a in (uv_p, gate, obs, obs_valid)]
    for s_, a in zip(slots, (uv_p, gate, obs, obs_valid)):
        s_[p_sel[~pad]] = a[~pad]
    kp_starts = [torch.from_numpy(np.asarray(a)) for a in args[4:]]
    got = guided_match_stage1_banded_reference(*[torch.from_numpy(a) for a in slots],
                                               torch.from_numpy(p_sel), *kp_starts, **tiles)
    want = guided_match_stage1_banded_reference(
        *[torch.from_numpy(a) for a in (uv_p, gate, obs, obs_valid)],
        torch.arange(G, dtype=torch.int32), *kp_starts, **tiles)
    assert (want[1].numpy() < 1e9).sum() > 80 and pad.sum() == 20
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[1].numpy()[pad], 1e9)


@pytest.mark.parametrize("case", ["uniform", "equal_y", "invalid_between", "on_the_radius",
                                  "far_rows"])
def test_k5_run_holds_every_pair_within_the_radius(rng, case):
    """tests/match_band_model.py, the kernel's run search in float32: the
    keypoints it walks hold every keypoint whose pair passes the pixel gate
    (the brute-force set over the band), and what passes on the walk is
    exactly that set. Cases: uniform keypoints; 300 keypoints on one y (one
    long run); invalid keypoints whose y lies between valid ones (their key
    is +inf, so they sort last); points placed at the radius and an ulp
    either side of it; positions near 1e4 px, where an ulp is ~1e-3 px."""
    from match_band_model import band_keys, run

    K, r = 1500, 28.0
    kp_uv = np.stack([rng.uniform(0, 640, K), rng.uniform(0, 480, K)], -1).astype(np.float32)
    kp_ok = rng.uniform(size=K) < 0.9
    uv = kp_uv[rng.integers(0, K, 400)] + rng.uniform(-30, 30, (400, 2)).astype(np.float32)
    if case == "equal_y":
        kp_uv[:300, 1] = 200.0
        uv[:200, 1] = 200.0 + rng.uniform(-1, 1, 200)
    elif case == "invalid_between":
        kp_ok[::3] = False
    elif case == "on_the_radius":
        src = rng.integers(0, K, 400)
        ang = rng.uniform(0, 2 * np.pi, 400)
        uv = (kp_uv[src] + r * np.stack([np.cos(ang), np.sin(ang)], -1)).astype(np.float32)
        uv[::3, 1] = kp_uv[src[::3], 1] + np.float32(r)  # straight above: dv = r
        uv[1::3, 1] = np.nextafter(uv[1::3, 1], np.float32(np.inf))
    elif case == "far_rows":
        kp_uv = (kp_uv + 1e4).astype(np.float32)
        uv = (uv + 1e4).astype(np.float32)
    uv = uv.astype(np.float32)
    order = np.argsort(np.where(kp_ok, kp_uv[:, 1], 1e8), kind="stable")
    kp_uv, kp_ok = kp_uv[order], kp_ok[order]
    keys = band_keys(kp_uv, kp_ok)
    assert (np.diff(keys[np.isfinite(keys)]) >= 0).all()
    r2 = np.float32(r * r)
    n_pass = 0
    for p in uv:
        d = p[None, :] - kp_uv
        brute = np.nonzero(kp_ok & (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] <= r2))[0]
        walked, passed = run(keys, kp_uv, p, r * r)
        assert set(brute) <= set(walked)
        assert sorted(passed) == brute.tolist()
        assert len(walked) <= len(brute) + 2 * 32 + np.sum(np.abs(keys - p[1]) <= r + 1)
        n_pass += len(brute)
    assert n_pass > 400


def _map_args(rng, P=300, K=1100, point_mask=None, kp_m=None, pt_m=None, grow_to=None):
    cam, pose, X, kp_uv, kp_desc, obs_desc, obs_valid = _setup(rng, P=P, K=K, D=32, O=3)
    if grow_to:
        # Map slots P..grow_to-1 sit behind the camera: valid, never gated.
        n = grow_to - P
        X = np.concatenate([X, rng.normal(0, 2, (n, 3)).astype(np.float32) * [1, 1, -1]
                            - [0, 0, 5]]).astype(np.float32)
        obs_desc = np.concatenate([obs_desc, rng.standard_normal((n, 3, 32)).astype(np.float32)])
        obs_valid = np.concatenate([obs_valid, np.ones((n, 3), bool)])
        P = grow_to
    ones_p, ones_k = np.ones(P, bool), np.ones(K, bool)
    return (cam, pose, X, ones_p if point_mask is None else point_mask, obs_desc, obs_valid,
            kp_uv, kp_desc, ones_k, np.zeros(K, bool) if kp_m is None else kp_m,
            np.zeros(P, bool) if pt_m is None else pt_m)


@pytest.mark.parametrize("case", ["full_gate", "partial_gate", "prefix_cap", "band_too_wide"])
def test_banded_map_to_frame_matches_jax(rng, case):
    """The port's backend="banded" against the JAX package's (Pallas in
    interpret mode), in the three cases of tests/test_map_matching.py:160-261
    and one where a tile's band needs more than two keypoint tiles
    (K=2400), so the dense kernel answers. Validity and point choice agree
    on >= 99 % of the keypoints (a near-tie may flip), distances to 1e-4;
    the port reports the fallback exactly when the band does not fit."""
    kw = {}
    if case == "partial_gate":
        kw = dict(point_mask=rng.random(300) < 0.3, kp_m=rng.random(1100) < 0.2,
                  pt_m=rng.random(300) < 0.1)
    elif case == "prefix_cap":
        kw = dict(P=500, grow_to=8192)
    elif case == "band_too_wide":
        kw = dict(K=2400)
    args = _map_args(rng, **kw)
    cam = args[0]
    want = jax_map_match(cam, *[jnp.asarray(a) for a in args[1:]], max_distance=0.8, chunk=32,
                         backend="banded")
    tk = [torch.from_numpy(np.asarray(a)) for a in args[1:]]
    tk[3] = tk[3].to(torch.bfloat16)  # the state's obs_desc cache is bf16
    got = tm.match_map_to_frame(Camera(*cam), *tk, max_distance=0.8, backend="banded")
    assert bool(got.fell_back) == (case == "band_too_wide")
    wv, gv = np.asarray(want.valid), got.valid.numpy()
    assert (wv == gv).mean() >= 0.99 and wv.sum() > 40
    both = wv & gv
    assert (np.asarray(want.point_idx)[both] == got.point_idx.numpy()[both]).mean() >= 0.99
    np.testing.assert_allclose(got.distance.numpy()[both], np.asarray(want.distance)[both],
                               atol=1e-4)
    dense = tm.match_map_to_frame(Camera(*cam), *tk, max_distance=0.8)
    assert dense.fell_back is None
    assert (dense.valid.numpy() == gv).mean() >= 0.99


# ---------------------------------------------------------------------------
# S frames at once (the lockstep step of S sequences)
# ---------------------------------------------------------------------------


def test_k5_twin_batched_equals_single_calls(rng):
    """The K5 twin over S=3 problems equals three single calls (atol 0)."""
    rows = [_banded_inputs(rng) for _ in range(3)]
    args = [torch.from_numpy(np.ascontiguousarray(np.stack([r[i] for r in rows])))
            for i in range(9)]
    args[2] = args[2].to(torch.bfloat16)
    P, G = args[0].shape[1], args[0].shape[1]
    p_sel = torch.arange(G, dtype=torch.int32).expand(3, G).contiguous()
    n_act = torch.from_numpy(np.stack([r[8] for r in rows]))
    n_act[1] = 1  # only the first tile of row 1 active
    kargs = (*args[:4], p_sel, *args[4:8], n_act)
    tiles = dict(radius_px=20.0, tile_p=64, tile_k=128, band_tiles=2)
    bk, bd = guided_match_stage1_banded_reference(*kargs, **tiles)
    assert bk.shape == bd.shape == (3, G) and (bd < 1e9).sum() > 300
    for s in range(3):
        sk, sd = guided_match_stage1_banded_reference(*[a[s] for a in kargs], **tiles)
        assert torch.equal(bk[s], sk) and torch.equal(bd[s], sd)
    assert bool((bd[1, 64:] == 1e9).all())


def test_banded_stage1_rows_equal_single_frames(rng):
    """band_plan and the banded stage 1 over S=3 frames, each row planned
    alone: every plan field and result row equals the single frame's,
    with K=2400 on 640x480 (5 keypoint tiles): rows 0 and 2 hold their
    points in a 40-pixel strip, so their bands fit, and row 1's points
    span the frame, so K2 answers that row alone (fell_back [F, T, F])."""
    rows = []
    for s in range(3):
        uv_p, gate, obs, ov, kp_uv, kp, kp_ok = _stage1_inputs(rng, 300, 4, 64, 2400)
        kp_uv = np.stack([rng.uniform(0, 640, 2400), rng.uniform(0, 480, 2400)], -1)
        src = rng.integers(0, 2400, 300)
        if s != 1:
            src = rng.choice(np.nonzero((kp_uv[:, 1] > 200) & (kp_uv[:, 1] < 240))[0], 300)
        uv_p = kp_uv[src] + rng.uniform(-5, 5, (300, 2))
        rows.append([a.astype(np.float32) if a.dtype == np.float64 else a
                     for a in (uv_p, gate, obs, ov, kp_uv, kp, kp_ok)])
    args = [torch.from_numpy(np.ascontiguousarray(np.stack([r[i] for r in rows])))
            for i in range(7)]
    args[2] = args[2].to(torch.bfloat16)
    plan = tm.band_plan(*args, radius_px=20.0)
    bk, bd, fell_back = tm._banded_stage1(*args, radius_px=20.0)
    assert fell_back.tolist() == [False, True, False]
    for s in range(3):
        one = [a[s] for a in args]
        p1 = tm.band_plan(*one, radius_px=20.0)
        for got, want in zip((*plan.k5_args[4:], plan.n_act, plan.fits, plan.kp_order),
                             (*p1.k5_args[4:], p1.n_act, p1.fits, p1.kp_order)):
            assert torch.equal(got[s], want)
        sk, sd, sf = tm._banded_stage1(*one, radius_px=20.0)
        assert torch.equal(bk[s], sk) and torch.equal(bd[s], sd) and bool(sf) == bool(fell_back[s])
        assert (sd < 1e9).sum() > 100


def test_match_frames_rows_equal_single_pairs(rng):
    """match_frames over S=3 frame pairs equals each pair alone (atol 0)."""
    S, K, D = 3, 150, 128
    d1 = _unit(rng.standard_normal((S, K, D))).astype(np.float32)
    d2 = _unit(d1[:, ::-1] + 0.03 * rng.standard_normal((S, K, D))).astype(np.float32)
    v1, v2 = rng.uniform(size=(S, K)) < 0.9, rng.uniform(size=(S, K)) < 0.9
    T = torch.from_numpy
    got = tm.match_frames(T(d1), T(v1), T(d2), T(v2), 0.8)
    assert int(got.valid.sum()) > 100
    for s in range(S):
        one = tm.match_frames(T(d1[s]), T(v1[s]), T(d2[s]), T(v2[s]), 0.8)
        for a, b in zip(got, one):
            assert torch.equal(a[s], b)
