"""The CUDA kernels against their plain twins on a CUDA card, at small
and ragged shapes (the main-path shapes are chip_smoke.py's).

These need a card: each test takes the `cuda` fixture, which skips without
one. On a machine with a card and no JAX, run them without the JAX test
configuration:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances and their reasons are chip_smoke.py's check_* docstrings.
"""

import functools

import numpy as np
import pytest
import torch

from racing_slam_tpu_torch.ops import matching
from racing_slam_tpu_torch.ops.kernels import attention as k6
from racing_slam_tpu_torch.ops.kernels import frontend as k1
from racing_slam_tpu_torch.ops.kernels import match as k2
from racing_slam_tpu_torch.ops.kernels import match_banded as k5
from racing_slam_tpu_torch.ops.kernels import motion_ba as k3
from racing_slam_tpu_torch.ops.kernels import structure_ba as k4
from match_grid_model import cell_grid

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda", 0)


def _texture(rng, H, W):
    from racing_slam_tpu_torch.utils.synthetic import random_texture

    return random_texture(H, W, rng)


@pytest.mark.parametrize("shape", [(96, 128), (100, 130), (2, 72, 90)])
@pytest.mark.parametrize("masked", [False, True])
def test_k1_kernel_matches_twin(cuda, shape, masked):
    rng = np.random.default_rng(1)
    H, W = shape[-2:]
    img = np.stack([_texture(rng, H, W) for _ in range(shape[0])]) if len(shape) == 3 \
        else _texture(rng, H, W)
    m = np.ones((H, W), np.float32)
    m[:, : W // 3] = 0
    x = torch.from_numpy(img).to(cuda)
    mask = torch.from_numpy(m).to(cuda) if masked else None
    got = [t.cpu().numpy() for t in k1.corner_frontend_fused(x, mask)]
    want = [t.cpu().numpy() for t in k1.corner_frontend_fused_reference(x, mask)]
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    assert np.mean((got[1] > 0) != (want[1] > 0)) <= 1e-3
    both = (got[1] > 0) & (want[1] > 0)
    np.testing.assert_allclose(got[1][both], want[1][both], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", [(480, 640), (720, 1280), (2, 480, 640), (100, 330),
                                   (20, 30)],
                         ids=["640x480", "1280x720", "batch2", "ragged", "below_halo"])
@pytest.mark.parametrize("masked", [False, True])
def test_k1_tiles_match_twin(cuda, shape, masked):
    """The redesigned K1 at chip_smoke.check_frontend's tolerances (peak
    status may differ on at most 1e-4 of the pixels): the main-path frame,
    720p, two frames at once, a frame whose sides are not whole tiles
    (100 x 330 against 80 x 32) and one smaller than the 13 px halo, with
    and without the mask (the bench's shape: bottom fifth and top twelfth
    blocked, scaled to the frame)."""
    rng = np.random.default_rng(3)
    H, W = shape[-2:]
    img = np.stack([_texture(rng, H, W) for _ in range(shape[0])]) if len(shape) == 3 \
        else _texture(rng, H, W)
    m = np.ones((H, W), np.float32)
    m[-max(H // 5, 1):, :] = 0
    m[: H // 12, :] = 0
    x = torch.from_numpy(img).to(cuda)
    mask = torch.from_numpy(m).to(cuda) if masked else None
    got = [t.cpu().numpy() for t in k1.corner_frontend_fused(x, mask)]
    want = [t.cpu().numpy() for t in k1.corner_frontend_fused_reference(x, mask)]
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    assert np.mean((got[1] > 0) != (want[1] > 0)) <= 1e-4
    both = (got[1] > 0) & (want[1] > 0)
    np.testing.assert_allclose(got[1][both], want[1][both], atol=2e-5, rtol=1e-4)
    if masked:
        assert got[0][..., m == 0].max() == 0.0
    assert (got[1] > 0).sum() > (0 if H < 30 else 20)


@functools.lru_cache(maxsize=None)
def _k1_base(H, W):
    return _texture(np.random.default_rng(8), H, W)


@pytest.mark.parametrize("B", [1, 2, 7, 8, 9, 17])
@pytest.mark.parametrize("shape", [(480, 640), (720, 1280), (100, 330)],
                         ids=["640x480", "1280x720", "ragged"])
@pytest.mark.parametrize("masked", [False, True])
def test_k1_batched_equals_single_launches(cuda, B, shape, masked):
    """K1 over B frames in one launch (B = 1 takes the single frame's
    80x32 tiles; B > 1 the 80x120 tiles: 32 blocks a 640x480 frame, 96 at
    720p, 5 at 100x330, so the B's fall on both sides of the card's 132
    SMs and of its waves): one count, each frame's maps equal to a launch
    on that frame alone to the bit, and the stack within check_frontend's
    tolerances of the twin. The frames are one texture shifted by a
    different amount each, scaled by a different contrast."""
    H, W = shape
    base = _k1_base(H, W)
    img = np.stack([np.roll(base, (13 * i, 29 * i), axis=(0, 1)) * (1.0 - 0.03 * i)
                    for i in range(B)]).astype(np.float32)
    m = np.ones((H, W), np.float32)
    m[-H // 5:, :] = 0
    m[: H // 12, :] = 0
    x = torch.from_numpy(img).to(cuda)
    mask = torch.from_numpy(m).to(cuda) if masked else None
    before = k1.launches
    got = k1.corner_frontend_fused(x, mask)
    assert k1.launches == before + 1
    for i in range(B):
        single = k1.corner_frontend_fused(x[i], mask)
        assert all(torch.equal(g[i], t) for g, t in zip(got, single)), f"frame {i} differs"
    got = [t.cpu().numpy() for t in got]
    want = [t.cpu().numpy() for t in k1.corner_frontend_fused_reference(x, mask)]
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    flips = ((got[1] > 0) != (want[1] > 0)).reshape(B, -1).mean(axis=1)
    assert flips.max() <= 1e-4, flips
    both = (got[1] > 0) & (want[1] > 0)
    np.testing.assert_allclose(got[1][both], want[1][both], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("O,D,K", [(3, 32, 100), (8, 128, 700), (5, 64, 257), (8, 256, 700),
                                   (4, 224, 300)])
def test_k2_kernel_matches_twin(cuda, O, D, K):
    rng = np.random.default_rng(2)
    P = 300
    kp_uv = np.stack([rng.uniform(0, 320, K), rng.uniform(0, 240, K)], -1).astype(np.float32)
    kp = rng.standard_normal((K, D)).astype(np.float32)
    kp /= np.linalg.norm(kp, axis=-1, keepdims=True)
    src = rng.integers(0, K, P)
    obs = kp[src][:, None] + 0.2 * rng.standard_normal((P, O, D)).astype(np.float32)
    obs /= np.linalg.norm(obs, axis=-1, keepdims=True)
    for i in range(0, 20, 2):  # exact ties
        kp[i + 1], kp_uv[i + 1] = kp[i], kp_uv[i] + 0.5
    args = [torch.from_numpy(a).to(cuda) for a in (
        (kp_uv[src] + rng.uniform(-5, 5, (P, 2))).astype(np.float32), rng.uniform(size=P) < 0.8,
        obs, rng.uniform(size=(P, O)) < 0.7, kp_uv, kp, rng.uniform(size=K) < 0.9)]
    args[2] = args[2].to(torch.bfloat16)
    bk, bd = [t.cpu().numpy() for t in k2.guided_match_stage1(*args, radius_px=20.0)]
    rk, rd = [t.cpu().numpy() for t in k2.guided_match_stage1_reference(*args, radius_px=20.0)]
    same = bk == rk
    assert same.mean() >= 0.99
    np.testing.assert_allclose(bd[same], rd[same], atol=1e-5)
    none = rd >= 1e9
    np.testing.assert_array_equal(bk[none], 0)
    np.testing.assert_array_equal(bd[none], 1e9)


def _match_inputs(rng, P, O, D, K, point_rows=480.0):
    """Keypoints over a 640 x 480 frame, points near keypoints in rows
    y < `point_rows`, unit descriptors, planted exact ties (keypoint 2i+1
    duplicates 2i)."""
    kp_uv = np.stack([rng.uniform(0, 640, K), rng.uniform(0, 480, K)], -1).astype(np.float32)
    kp = rng.standard_normal((K, D)).astype(np.float32)
    kp /= np.linalg.norm(kp, axis=-1, keepdims=True)
    for i in range(0, 40, 2):
        kp[i + 1], kp_uv[i + 1] = kp[i], kp_uv[i] + 0.5
    src = rng.choice(np.nonzero(kp_uv[:, 1] < point_rows)[0], P)
    obs = kp[src][:, None] + 0.2 * rng.standard_normal((P, O, D)).astype(np.float32)
    obs /= np.linalg.norm(obs, axis=-1, keepdims=True)
    uv_p = (kp_uv[src] + rng.uniform(-5, 5, (P, 2))).astype(np.float32)
    return (uv_p, rng.uniform(size=P) < 0.8, obs, rng.uniform(size=(P, O)) < 0.7, kp_uv, kp,
            rng.uniform(size=K) < 0.9)


@pytest.mark.parametrize("D", [128, 256])
def test_k5_kernel_matches_twin(cuda, D):
    """K5 on sorted inputs with bands chosen per point tile and one inactive
    tile; tolerances as K2's."""
    rng = np.random.default_rng(5)
    tile_p, tile_k, band, P, K = 256, 512, 2, 1024, 2560
    uv_p, gate, obs, ov, kp_uv, kp, kp_ok = _match_inputs(rng, P, 8, D, K)
    gate[-tile_p:] = False
    ko = np.argsort(np.where(kp_ok, kp_uv[:, 1], 1e8), kind="stable")
    kp_uv, kp, kp_ok = kp_uv[ko], kp[ko], kp_ok[ko]
    po = np.argsort(np.where(gate, uv_p[:, 1], 1e8), kind="stable")
    uv_p, gate, obs, ov = uv_p[po], gate[po], obs[po], ov[po]
    mid = np.searchsorted(np.where(kp_ok, kp_uv[:, 1], 1e8),
                          uv_p[:, 1].reshape(-1, tile_p).mean(1)) // tile_k
    starts = np.clip(mid - 1, 0, K // tile_k - band).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        uv_p, gate, obs, ov, np.arange(P, dtype=np.int32), kp_uv, kp, kp_ok, starts)]
    args[2] = args[2].to(torch.bfloat16)
    args.append(torch.tensor(3, dtype=torch.int32, device=cuda))
    bk, bd = [t.cpu().numpy() for t in k5.guided_match_stage1_banded(*args, radius_px=20.0)]
    rk, rd = [t.cpu().numpy() for t in k5.guided_match_stage1_banded_reference(*args,
                                                                            radius_px=20.0)]
    assert (rd < 1e9).sum() > 300
    same = bk == rk
    assert same.mean() >= 0.99
    np.testing.assert_allclose(bd[same], rd[same], atol=1e-5)
    none = rd >= 1e9
    assert none[-tile_p:].all()
    np.testing.assert_array_equal(bk[none], 0)
    np.testing.assert_array_equal(bd[none], 1e9)


@pytest.mark.parametrize("P,point_rows,fits", [(300, 480.0, False), (1200, 40.0, True)])
def test_banded_stage1_falls_back_on_the_device(cuda, P, point_rows, fits):
    """The banded stage 1 (K5 + K2 with its skip flag) against K2's twin,
    K=2400: one tile of points over the whole frame needs all five keypoint
    tiles, so K2 does the search; points in a 40-row strip fit their bands
    and K5 does."""
    rng = np.random.default_rng(8)
    args = [torch.from_numpy(a).to(cuda) for a in _match_inputs(rng, P, 8, 128, 2400,
                                                                 point_rows)]
    args[2] = args[2].to(torch.bfloat16)
    bk, bd, fell_back = matching._banded_stage1(*args, radius_px=20.0)
    rk, rd = k2.guided_match_stage1_reference(*args, radius_px=20.0)
    assert bool(fell_back) != fits
    bk, bd, rk, rd = [t.cpu().numpy() for t in (bk, bd, rk, rd)]
    hit = rd < 1e9
    assert hit.sum() > P // 2
    np.testing.assert_array_equal(bd >= 1e9, ~hit)
    # Unmatched points carry no keypoint (the banded path maps sorted index
    # 0 back to the first y-sorted keypoint, as the JAX package does).
    same = bk[hit] == rk[hit]
    assert same.mean() >= 0.99
    np.testing.assert_allclose(bd[hit][same], rd[hit][same], atol=1e-5)


def _k5_case(rng, case):
    """Unsorted map and frame data for one K5 case, with its tiling: K5
    runs on band_plan's sorted keypoints and reads the points through its
    p_sel (sorted gated-first by y, padded past P)."""
    tiles = dict(radius_px=20.0, tile_p=256, tile_k=512, band_tiles=4)
    P, O, D, K, W, H, rows = 1000, 8, 128, 2400, 640, 480, 480.0
    if case == "d256":
        D = 256
    elif case == "last_tile":
        rows = None  # the points in the bottom 60 rows
        tiles["band_tiles"] = 2
    elif case == "prune_720p":
        P, K, W, H = 16384, 7200, 1280, 720
        tiles.update(radius_px=28.0, band_tiles=3)
    kp_uv = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32)
    kp = rng.standard_normal((K, D)).astype(np.float32)
    kp /= np.linalg.norm(kp, axis=-1, keepdims=True)
    kp_ok = rng.uniform(size=K) < 0.9
    for i in range(0, 60, 2):  # exact ties, half a pixel apart
        kp[i + 1], kp_uv[i + 1] = kp[i], kp_uv[i] + 0.5
        kp_ok[i] = kp_ok[i + 1] = True
    if case == "equal_y":  # one long run: 400 keypoints on one row
        kp_uv[100:500, 1] = 240.0
    if case == "invalid_between":  # every third keypoint ungated, between valid ones in y
        kp_ok[60::3] = False
    near = np.nonzero(kp_uv[:, 1] >= H - 60)[0] if rows is None else np.arange(K)
    src = rng.choice(near, P)
    if case == "equal_y":
        src[: P // 2] = rng.integers(100, 500, P // 2)
    obs = kp[src][:, None] + 0.2 * rng.standard_normal((P, O, D)).astype(np.float32)
    obs /= np.linalg.norm(obs, axis=-1, keepdims=True)
    uv_p = (kp_uv[src] + rng.uniform(-5, 5, (P, 2))).astype(np.float32)
    if case == "equal_y":
        uv_p[: P // 2, 1] = 240.0
    gate = rng.uniform(size=P) < 0.8
    if case == "prune_720p":
        gate = np.zeros(P, bool)
        gate[rng.choice(P, 6000, replace=False)] = True
    return (uv_p, gate, obs, rng.uniform(size=(P, O)) < 0.7, kp_uv, kp, kp_ok), tiles


@pytest.mark.parametrize("case", ["equal_y", "invalid_between", "last_tile", "inactive", "d256",
                                  "prune_720p"])
def test_k5_run_cases_match_twin(cuda, case):
    """The redesigned K5 against its twin on band_plan's own inputs, so that
    it reads the points through a p_sel that is not the identity, at
    chip_smoke.check_match_banded's tolerances: best_d to 1e-5 everywhere,
    the keypoint on >= 99.9 % of the matched rows, every planted tie (two
    equal descriptors half a pixel apart) to the lower sorted index,
    unmatched rows (0, 1e9). On 640x480 with K=2400 (5 keypoint tiles) and
    bands of 4 tiles: 400 keypoints on one row with half the points on it
    (a run of 400); every third keypoint ungated; the points in the bottom
    rows with bands of 2, so that their bands end at the last keypoint
    tile; only the first of the active tiles switched on (the others must
    write (0, 1e9) untouched); D=256; 1280x720 with K=7200, where a band of
    3 of the 15 keypoint tiles holds each point tile's candidates."""
    rng = np.random.default_rng(21)
    data, tiles = _k5_case(rng, case)
    args = [torch.from_numpy(a).to(cuda) for a in data]
    args[2] = args[2].to(torch.bfloat16)
    plan = matching.band_plan(*args, **tiles)
    assert bool(plan.fits)
    n_act = plan.n_act.to(torch.int32)
    if case == "inactive":
        assert int(n_act) >= 3
        n_act = torch.ones_like(n_act)
    p_sel = plan.k5_args[4].cpu().numpy()
    assert not np.array_equal(p_sel, np.arange(len(p_sel)))
    if case == "last_tile":
        n_k = plan.k5_args[5].shape[0] // tiles["tile_k"]
        assert int(plan.k5_args[8][0]) == n_k - tiles["band_tiles"]
    kargs = (*plan.k5_args, n_act)
    bk, bd = [t.cpu().numpy() for t in k5.guided_match_stage1_banded(*kargs, **tiles)]
    rk, rd = [t.cpu().numpy() for t in k5.guided_match_stage1_banded_reference(*kargs, **tiles)]
    hit = rd < 1e9
    assert hit.sum() > (100 if case == "inactive" else 400)
    assert np.abs(bd - rd).max() <= 1e-5
    assert (bk[hit] == rk[hit]).mean() >= 0.999
    np.testing.assert_array_equal(bk[~hit], 0)
    np.testing.assert_array_equal(bd[~hit], 1e9)
    if case == "inactive":
        assert not hit[tiles["tile_p"]:].any()
    # Planted ties: the twin's choice is the lower sorted index of a pair.
    pos = np.empty(plan.kp_order.shape[0], np.int64)
    order = plan.kp_order.cpu().numpy()
    pos[order[: len(data[4])]] = np.arange(len(data[4]))
    lower = np.minimum(pos[0:60:2], pos[1:60:2])
    ties = np.isin(rk, lower) & hit
    assert ties.sum() > 0
    np.testing.assert_array_equal(bk[ties], rk[ties])


def _rot(w):
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


@pytest.mark.parametrize("case", ["clean", "outliers", "all_invalid"])
def test_k3_kernel_matches_twin(cuda, case):
    rng = np.random.default_rng(3)
    n, fx, cx, cy = 150, 500.0, 320.0, 240.0
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(4, 10, n)], -1)
    w, t = np.array([0.03, -0.1, 0.02]), np.array([0.3, -0.1, 0.2])
    Xc = X @ _rot(w).T + t
    uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    if case == "outliers":
        uv[:15] += rng.uniform(80, 200, (15, 2))
    valid = np.full(n, case != "all_invalid")
    pose0 = np.concatenate([w + [0.02, -0.015, 0.01], t + [0.05, -0.04, 0.06]])
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)  # noqa: E731
    args = (f32(pose0), f32(uv), f32(X), torch.from_numpy(valid).to(cuda))
    huber = 2.45 / fx if case == "outliers" else float(np.sqrt(5.991))
    kw = dict(fx=fx, cx=cx, cy=cy, max_iters=10, huber_delta=huber)
    out = k3.motion_ba_lm(*args, **kw).cpu().numpy()
    ref = k3.motion_ba_lm_reference(*args, **kw).cpu().numpy()
    if case == "all_invalid":
        np.testing.assert_array_equal(out[:6], pose0.astype(np.float32))
        return
    np.testing.assert_allclose(out[:3], ref[:3], atol=1e-5)
    np.testing.assert_allclose(out[3:6], ref[3:6], atol=1e-4)
    assert abs(out[6] - ref[6]) <= 0.01 * ref[6] + 1e-10, (out[6], ref[6])


@pytest.mark.parametrize("frozen", [0, 20])
def test_k4_kernel_matches_twin(cuda, frozen):
    rng = np.random.default_rng(4)
    F, P, O, fx, cx, cy = 3, 80, 4, 500.0, 320.0, 240.0
    rv = np.stack([[0.0, 0.05 * i, 0.0] for i in range(F)])
    tv = np.stack([[0.4 * i, 0.02 * i, 0.01 * i] for i in range(F)])
    X = np.stack([rng.uniform(-3, 3, P), rng.uniform(-3, 3, P), rng.uniform(4, 10, P)], -1)
    obs_cam = np.tile(np.arange(O) % F, (P, 1))
    obs_uv = np.zeros((P, O, 2))
    for o in range(O):
        Xc = X @ _rot(rv[o % F]).T + tv[o % F]
        obs_uv[:, o] = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    include = np.zeros((P, O), bool)
    include[:, :F] = True
    rv0, tv0 = rv.copy(), tv.copy()
    rv0[2] += [0.01, 0.02, -0.01]
    tv0[2] += [0.06, -0.04, 0.05]
    free = np.arange(P) >= frozen
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)  # noqa: E731
    args = (f32(rv0), f32(tv0), f32(X + rng.normal(0, 0.03, X.shape)),
            torch.from_numpy(obs_cam.astype(np.int64)).to(cuda), f32(obs_uv),
            torch.from_numpy(include).to(cuda), torch.from_numpy(free).to(cuda),
            torch.full((), 2, dtype=torch.int64, device=cuda))
    kw = dict(fx=fx, cx=cx, cy=cy, max_iters=10, huber_delta=float(np.sqrt(5.991)))
    out, pts = [t.cpu().numpy() for t in k4.structure_ba_lm(*args, **kw)]
    ref, rpts = [t.cpu().numpy() for t in k4.structure_ba_lm_reference(*args, **kw)]
    np.testing.assert_allclose(out[:3], ref[:3], atol=1e-5)
    np.testing.assert_allclose(out[3:6], ref[3:6], atol=1e-4)
    assert abs(out[6] - ref[6]) <= 0.01 * ref[6] + 1e-10, (out[6], ref[6])
    assert np.median(np.linalg.norm(pts - rpts, axis=-1)) < 1e-4
    np.testing.assert_array_equal(pts[:frozen], args[2].cpu().numpy()[:frozen])


def _k4_problem(rng, P, F=64, O=8, frozen=0, free_slot=None):
    """A commit problem at P points with F cameras, each point seen by the
    O newest (the newest free unless `free_slot` says otherwise), 0.5 px
    noise, 80 % of observations kept. The cameras step 0.4 units sideways
    and the points lie 6-12 units deep, so every point's depth is well
    determined: the twin against itself with its points reordered differs
    by under 1e-4 here (the bench dolly's 0.05-unit steps leave depths so
    weak that the twin reordered moves a few points by tenths of a unit)."""
    fx, cx, cy = 480.0, 320.0, 240.0
    rv = np.stack([[0.0, 0.01 * (f - F + 1), 0.0] for f in range(F)])
    tv = np.stack([-np.array([0.4, 0.04, 0.1]) * (f - F + 1) for f in range(F)])
    X = np.stack([rng.uniform(-4, 4, P), rng.uniform(-3, 3, P), rng.uniform(6, 12, P)], -1)
    obs_cam = np.tile(F - 1 - np.arange(O), (P, 1))
    obs_uv = np.zeros((P, O, 2))
    for o in range(O):
        Xc = X @ _rot(rv[F - 1 - o]).T + tv[F - 1 - o]
        obs_uv[:, o] = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    obs_uv += rng.normal(0, 0.5, obs_uv.shape)
    include = rng.uniform(size=(P, O)) < 0.8
    include[:, 0] = True
    slot = F - 1 if free_slot is None else free_slot
    rv0, tv0 = rv.copy(), tv.copy()
    rv0[slot] += [0.004, -0.003, 0.002]
    tv0[slot] += [0.03, -0.02, 0.04]
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    args = (f32(rv0), f32(tv0), f32(X + rng.normal(0, 0.02, X.shape)),
            torch.from_numpy(obs_cam.astype(np.int64)), f32(obs_uv), torch.from_numpy(include),
            torch.from_numpy(np.arange(P) >= frozen), torch.tensor(slot, dtype=torch.int64))
    return args, dict(fx=fx, cx=cx, cy=cy, max_iters=10, huber_delta=float(np.sqrt(5.991)) / fx)


@pytest.mark.parametrize("P,frozen,free_slot", [
    (1, 0, 0),  # one point; the free camera sees nothing, so the point alone moves
    (k4.CLUSTER - 1, 8, None),  # fewer points than CTAs (8 frozen anchor the camera)
    (2433, 100, None),  # ragged: not a multiple of the cluster
    (7296, 100, None),  # the 720p commit
    (17000, 100, None),  # past 16384 points: the points' state in the global scratch
    (600, 600, None),  # every point frozen: the camera alone moves
])
def test_k4_cluster_matches_twin_and_repeats_bit_for_bit(cuda, P, frozen, free_slot):
    """K4 (one cluster of k4.CLUSTER CTAs) at F = 64 against its twin with
    the function-tolerance exit off, to chip_smoke.py check_structure_ba's
    tolerances (pose 1e-5 / 1e-4, cost 1 %, same iterations, median point
    difference 1e-4, every point within 5e-2), frozen points untouched;
    then a second run on the same inputs gives the same bits."""
    args, kw = _k4_problem(np.random.default_rng(40 + P), P, frozen=frozen, free_slot=free_slot)
    args = tuple(a.to(cuda) for a in args)
    out, pts = k4.structure_ba_lm(*args, **kw, ftol=0.0)
    out2, pts2 = k4.structure_ba_lm(*args, **kw, ftol=0.0)
    ref, rpts = k4.structure_ba_lm_reference(*args, **kw, ftol=0.0)
    assert torch.equal(out, out2) and torch.equal(pts, pts2), "K4 runs differ"
    out, pts, ref, rpts = [t.cpu().numpy() for t in (out, pts, ref, rpts)]
    np.testing.assert_allclose(out[:3], ref[:3], atol=1e-5)
    np.testing.assert_allclose(out[3:6], ref[3:6], atol=1e-4)
    assert abs(out[6] - ref[6]) <= 0.01 * ref[6] + 1e-10, (out[6], ref[6])
    assert out[7] == ref[7], (out[7], ref[7])
    perr = np.linalg.norm(pts - rpts, axis=-1)
    assert np.median(perr) < 1e-4 and perr.max() < 5e-2, (np.median(perr), perr.max())
    np.testing.assert_array_equal(pts[:frozen], args[2].cpu().numpy()[:frozen])


@pytest.mark.parametrize("C,P", [(1, 2432), (3, 2432), (8, 2432), (3, 17000)],
                         ids=["C1", "C3", "C8", "C3_scratch"])
def test_k4_batched_equals_single_launches(cuda, C, P):
    """K4 over C problems in one launch of C clusters (the commits of the
    rows that commit on one lockstep frame), each with its own data, free
    slot and frozen share; at P = 17000 every problem's points overflow
    shared memory into its own slice of the scratch. Each problem's pose,
    cost, iterations and points bit-equal to a launch of that problem
    alone, one count in `launches` and `batched_launches` for the batched
    call and none of the latter for the single ones, and each problem
    within test_k4_cluster_matches_twin_and_repeats_bit_for_bit's rules
    against the twin (the exit off)."""
    probs = [_k4_problem(np.random.default_rng(300 + c), P, frozen=(0, 100, 600)[c % 3],
                         free_slot=(None, 61, 40)[c % 3]) for c in range(C)]
    kw = dict(probs[0][1], ftol=0.0)
    args = [torch.stack([p[0][i] for p in probs]).to(cuda) for i in range(8)]
    before = (k4.launches, k4.batched_launches)
    out, pts = k4.structure_ba_lm(*args, **kw)
    assert (k4.launches, k4.batched_launches) == (before[0] + 1, before[1] + 1)
    assert out.shape == (C, 8) and pts.shape == (C, P, 3)
    for c in range(C):
        one, one_pts = k4.structure_ba_lm(*[a[c] for a in args], **kw)
        assert torch.equal(out[c], one) and torch.equal(pts[c], one_pts), f"problem {c}"
    assert k4.batched_launches == before[1] + 1  # the single launches counted apart
    ref, rpts = k4.structure_ba_lm_reference(*args, **kw)
    out, pts, ref, rpts = [t.cpu().numpy() for t in (out, pts, ref, rpts)]
    for c in range(C):
        np.testing.assert_allclose(out[c, :3], ref[c, :3], atol=1e-5)
        np.testing.assert_allclose(out[c, 3:6], ref[c, 3:6], atol=1e-4)
        assert abs(out[c, 6] - ref[c, 6]) <= 0.01 * ref[c, 6] + 1e-10, (c, out[c, 6], ref[c, 6])
        assert out[c, 7] == ref[c, 7], (c, out[c, 7], ref[c, 7])
        perr = np.linalg.norm(pts[c] - rpts[c], axis=-1)
        assert np.median(perr) < 1e-4 and perr.max() < 5e-2, (c, np.median(perr), perr.max())
        frozen = (0, 100, 600)[c % 3]
        np.testing.assert_array_equal(pts[c, :frozen], args[2][c, :frozen].cpu().numpy())


@pytest.mark.parametrize("C", [1, 7, 8])
def test_k4_commit_problems_batched_equal_single_launches(cuda, C):
    """K4 over C of chip_smoke.py's commit problems (the bench dolly: 2432
    points x 8 observations, F = 32, seeds 13.., free cameras 31, 30, 29,
    28, ...) in one launch of C clusters, C = 8 being a lockstep frame on
    which every row commits: each problem bit-equal to its launch alone
    with the exit off and on, and held to the twin by chip_smoke._k4_rule
    (every point within twice the twin's own spread over ten reorderings
    of its points, the weak-depth points near the epipole). The card holds
    all 8 clusters at once."""
    import chip_smoke as cs

    data = [cs._k4_data(cuda, seed=13 + i, free=31 - i % 4) for i in range(C)]
    kw = data[0][1]
    args = [torch.stack([d[0][j] for d in data]) for j in range(8)]
    assert k4.max_active_clusters(2432, 8) >= 8
    for fkw in (dict(kw, ftol=0.0), kw):
        out, pts = k4.structure_ba_lm(*args, **fkw)
        for c, (row, _, _) in enumerate(data):
            one, one_pts = k4.structure_ba_lm(*row, **fkw)
            assert torch.equal(out[c], one) and torch.equal(pts[c], one_pts), f"problem {c}"
    out, pts = k4.structure_ba_lm(*args, **kw, ftol=0.0)
    ref, rpts = k4.structure_ba_lm_reference(*args, **kw, ftol=0.0)
    out, pts, ref, rpts = [t.cpu().numpy() for t in (out, pts, ref, rpts)]
    for c, (row, _, d) in enumerate(data):
        spread = cs._twin_order_spread(k4, row, kw, n=10)
        cs._k4_rule(out[c], pts[c], ref[c], rpts[c], d, spread, f"K4 problem {c}")


@pytest.mark.parametrize("Kq,Kk,dh,valid,chunks", [
    (2400, 130, 32, 0.8, None),  # fewer keys than one chunk of the default split
    (2400, 130, 32, 0.8, 4),  # 3 key tiles in 4 chunks: the last all padding
    (2400, 2400, 32, 0.8, 20),  # 40 tiles of which 38 hold keys: the last chunk all padding
    (500, 700, 32, 0.0, None),  # every key masked: uniform through the combine
    (300, 900, 16, 0.6, None),
    (300, 900, 64, 0.6, None),
])
def test_k6_split_cases_match_twin(cuda, Kq, Kk, dh, valid, chunks):
    """K6's split and combine (key chunks smaller than, equal to or past
    the keys), to the 5 %-of-RMS limit against the unsplit twin."""
    rng = np.random.default_rng(60 + Kk + dh)
    H = 4
    q, k, v = [torch.from_numpy(rng.normal(size=(n, H, dh)).astype(np.float32)).to(cuda)
               for n in (Kq, Kk, Kk)]
    mask = torch.from_numpy(rng.random(Kk) < valid).to(cuda)
    got = k6.flash_mha(q, k, v, mask, chunks=chunks).cpu().numpy()
    want = k6.flash_mha_reference(q, k, v, mask).cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.05 * np.sqrt(np.mean(want**2)), rtol=0)


@pytest.mark.parametrize("Kq,Kk,dh,valid", [(2400, 2400, 32, 0.8), (300, 2333, 32, 0.8),
                                            (100, 333, 32, 0.0), (77, 130, 16, 0.5),
                                            (200, 200, 64, 1.0)])
def test_k6_kernel_matches_twin(cuda, Kq, Kk, dh, valid):
    """Tolerance 5 % of the twin's output RMS (chip_smoke.py
    check_attention; about 1.9e-3 at [2400, 2400], 9e-3 at 130 keys): the
    kernel's 64-key tiles round p to bf16 against another running max than
    the twin's 512-key tiles."""
    rng = np.random.default_rng(6)
    H = 4
    q, k, v = [torch.from_numpy(rng.normal(size=(n, H, dh)).astype(np.float32)).to(cuda)
               for n in (Kq, Kk, Kk)]
    mask = torch.from_numpy(rng.random(Kk) < valid).to(cuda)
    got = k6.flash_mha(q, k, v, mask).cpu().numpy()
    want = k6.flash_mha_reference(q, k, v, mask).cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.05 * np.sqrt(np.mean(want**2)), rtol=0)


@pytest.mark.parametrize("Kq,Kk,dh,valid", [
    (2400, 2400, 32, (0.8, 0.0, 0.5)),  # LightGlue's shape, one row all masked
    (600, 2333, 32, (0.9, 0.6, 0.3)),  # a ragged key count: a partial last key tile
    (300, 130, 16, (0.5, 1.0, 0.7)),  # fewer keys than one chunk
])
def test_k6_batched_equals_single_calls(cuda, Kq, Kk, dh, valid):
    """K6 over S = 3 problems in one call (LightGlue over the frame pairs of
    a lockstep frame): each row bit-equal to a call on that row alone (the
    batched call splits the keys as one row's does), one count of
    `launches` and of `batched_launches`, and each row within
    test_k6_kernel_matches_twin's limit of the batched twin (5 % of that
    row's twin output RMS)."""
    rng = np.random.default_rng(70 + Kk + dh)
    S, H = len(valid), 4
    q, k, v = [torch.from_numpy(rng.normal(size=(S, n, H, dh)).astype(np.float32)).to(cuda)
               for n in (Kq, Kk, Kk)]
    mask = torch.from_numpy(np.stack([rng.random(Kk) < f for f in valid])).to(cuda)
    before = (k6.launches, k6.batched_launches)
    got = k6.flash_mha(q, k, v, mask)
    assert (k6.launches, k6.batched_launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == (S, Kq, H, dh)
    want = k6.flash_mha_reference(q, k, v, mask).cpu().numpy()
    for s in range(S):
        assert torch.equal(got[s], k6.flash_mha(q[s], k[s], v[s], mask[s])), f"row {s}"
        g = got[s].cpu().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, want[s], atol=0.05 * np.sqrt(np.mean(want[s] ** 2)), rtol=0)
    assert k6.batched_launches == before[1] + 1  # the single calls counted apart


@pytest.mark.parametrize("Kk", [2400, 2333])
@pytest.mark.parametrize("S", [1, 2, 7, 8])
def test_k6_rows_equal_single_calls_at_every_S(cuda, S, Kk):
    """K6 over S rows at LightGlue's [2400, 4, 32], each row with its own
    share of valid keys (so a ragged count of valid keys across rows, one
    row all masked at S >= 7): whatever CTAs `launch_plan` gives the S rows
    (one chunk a CTA at S = 1 and 2, every chunk of a tile in one CTA that
    merges them itself at S = 7 and 8), each row bit-equal to a call on
    that row alone, whose CTAs each run one chunk; and within
    test_k6_kernel_matches_twin's limit of the twin."""
    rng = np.random.default_rng(80 + S + Kk)
    H, dh, Kq = 4, 32, 2400
    shares = (0.95, 0.9, 0.8, 0.7, 0.5, 0.3, 0.1, 0.0)[-S:] if S > 1 else (0.6,)
    q, k, v = [torch.from_numpy(rng.normal(size=(S, n, H, dh)).astype(np.float32)).to(cuda)
               for n in (Kq, Kk, Kk)]
    mask = torch.from_numpy(np.stack([rng.random(Kk) < f for f in shares])).to(cuda)
    plan = k6.launch_plan(S, Kq, Kk, H)
    assert plan.chunks == k6.launch_plan(1, Kq, Kk, H).chunks
    got = k6.flash_mha(q, k, v, mask)
    want = k6.flash_mha_reference(q, k, v, mask).cpu().numpy()
    for s in range(S):
        assert torch.equal(got[s], k6.flash_mha(q[s], k[s], v[s], mask[s])), f"row {s}, {plan}"
        g = got[s].cpu().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, want[s], atol=0.05 * np.sqrt(np.mean(want[s] ** 2)), rtol=0)


def _k2_inputs(rng, P, K, W, H, D, radius, O=8, ties=20):
    """Keypoints over a W x H frame, points within 0.8 radius of random
    keypoints, unit descriptors, `ties` planted exact ties (keypoint 2i+1
    duplicates 2i's descriptor, 0.1 radius away)."""
    kp_uv = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32)
    kp = rng.standard_normal((K, D)).astype(np.float32)
    kp /= np.linalg.norm(kp, axis=-1, keepdims=True)
    for i in range(0, min(2 * ties, K - 1), 2):
        kp[i + 1], kp_uv[i + 1] = kp[i], kp_uv[i] + 0.1 * radius
    src = rng.integers(0, K, P)
    obs = kp[src][:, None] + 0.2 * rng.standard_normal((P, O, D)).astype(np.float32)
    obs /= np.linalg.norm(obs, axis=-1, keepdims=True)
    off = rng.uniform(-0.55, 0.55, (P, 2)) * radius
    return [(kp_uv[src] + off).astype(np.float32), rng.uniform(size=P) < 0.8, obs,
            rng.uniform(size=(P, O)) < 0.7, kp_uv, kp, rng.uniform(size=K) < 0.9]


def _k2_check(cuda, data, radius, skip=None):
    """K2 against its twin: >= 99.9 % of the points pick the same keypoint,
    distances within 1e-5 where they do, unmatched points (0, 1e9), and
    every point whose twin picked a planted tie's lower index picks it."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in data]
    args[2] = args[2].to(torch.bfloat16)
    bk, bd = [t.cpu().numpy() for t in k2.guided_match_stage1(*args, radius_px=radius,
                                                               skip=skip)]
    rk, rd = [t.cpu().numpy() for t in k2.guided_match_stage1_reference(*args,
                                                                        radius_px=radius)]
    if skip is not None and bool(skip):
        np.testing.assert_array_equal(bk, 0)
        np.testing.assert_array_equal(bd, 1e9)
        return rk, rd
    same = bk == rk
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(bd[same], rd[same], atol=1e-5)
    none = rd >= 1e9
    np.testing.assert_array_equal(bk[none], 0)
    np.testing.assert_array_equal(bd[none], 1e9)
    lower = np.isin(rk, np.arange(0, 40, 2)) & ~none
    np.testing.assert_array_equal(bk[lower], rk[lower])
    return rk, rd


@pytest.mark.parametrize("case", ["one_cell", "ties_across_cells", "border_ulps", "off_frame",
                                  "radius_0.5", "radius_80", "720p_K7200", "K1"])
def test_k2_cell_grid_cases_match_twin(cuda, case):
    """K2's cell-binned search on inputs that stress the grid: every
    keypoint in one cell; exact ties whose lower index lies in the later
    cell; points exactly on the cell borders of the grid model
    (tests/match_grid_model.py) and an ulp below them, each with its best
    keypoint at the radius on the far side of the border or an ulp beyond
    the radius; points off the frame and at negative coordinates; radius
    0.5 px (the grid's side set by the cap) and 80 px; 7200 keypoints on
    1280 x 720 (two binning chunks); a single keypoint."""
    rng = np.random.default_rng(70 + len(case))
    D, r, P, K, W, H = 128, 28.0, 600, 2400, 640, 480
    if case == "radius_0.5":
        r = 0.5
    elif case == "radius_80":
        r = 80.0
    elif case == "720p_K7200":
        P, K, W, H, r = 2000, 7200, 1280, 720, 42.0
    elif case == "K1":
        K = 1
    data = _k2_inputs(rng, P, K, W, H, D, r)
    if case == "one_cell":
        data[4] = (100.0 + rng.uniform(0, 5, (K, 2))).astype(np.float32)
        data[0] = (100.0 + rng.uniform(-15, 20, (P, 2))).astype(np.float32)
    elif case == "ties_across_cells":
        lo_u, lo_v, side, nx, _ = cell_grid(data[4], data[6], r)
        for i in range(0, 40, 2):
            border = lo_u + side * (1 + i % (nx - 2))
            data[4][i, 0], data[4][i + 1, 0] = border + 0.3, border - 0.3  # lower index: later cell
            data[4][i + 1, 1] = data[4][i, 1]
            data[6][i] = data[6][i + 1] = True
            data[0][i // 2] = data[4][i] - [0.3, 1.0]  # point i/2 between the two
            data[1][i // 2] = True
            data[3][i // 2] = True
            data[2][i // 2] = data[5][i]
        assert cell_grid(data[4], data[6], r)[:3] == (lo_u, lo_v, side), "the grid moved"
    elif case == "border_ulps":
        grid = cell_grid(data[4], data[6], r)
        lo_u, _, side, nx, _ = grid
        uv, ok = data[4][data[6]], np.nonzero(data[6])[0]
        extreme = ok[[uv[:, 0].argmin(), uv[:, 0].argmax(), uv[:, 1].argmin(), uv[:, 1].argmax()]]
        q = P // 4
        kid = np.setdiff1d(np.arange(40, K), extreme)[: 2 * q]  # past the planted ties
        b = (lo_u + side * rng.integers(1, nx - 1, 2 * q)).astype(np.float32)
        pu = np.where(rng.uniform(size=2 * q) < 0.5, b, np.nextafter(b, np.float32(-1e9)))
        data[0][: 2 * q, 0] = pu
        # The first q points' keypoints lie an ulp beyond the radius to the
        # right, the next q points' at the radius to the left.
        data[4][kid[:q], 0] = np.nextafter(pu[:q] + np.float32(r), np.float32(1e9))
        data[4][kid[q:], 0] = pu[q:] - np.float32(r)
        data[4][kid, 1] = data[0][: 2 * q, 1]
        data[6][kid] = True
        data[1][: 2 * q] = True
        data[3][: 2 * q] = True
        data[2][: 2 * q] = data[5][kid][:, None, :]
        assert cell_grid(data[4], data[6], r) == grid, "the grid moved"
    elif case == "off_frame":
        data[0][: P // 2] += rng.choice([-1.0, 1.0], (P // 2, 2)) * rng.uniform(5, 60, (P // 2, 2))
        data[0][P // 2: P // 2 + 20] = -rng.uniform(0, 30, (20, 2))
    rk, rd = _k2_check(cuda, data, r)
    if case != "K1":
        assert (rd < 1e9).sum() > P // 4
    if case == "ties_across_cells":
        assert (rk[:20] == np.arange(0, 40, 2)).all(), "the planted ties are not this case's answer"
    if case == "border_ulps":  # the planted pairs decide this case's answers
        assert (rk[:q] != kid[:q]).all() and (rk[q: 2 * q] == kid[q:]).mean() > 0.95


@pytest.mark.parametrize("skip", [True, False])
def test_k2_skip_instance(cuda, skip):
    """The instance that reads the device `skip` flag: set, it writes
    (0, 1e9) everywhere; unset, it answers as the twin."""
    data = _k2_inputs(np.random.default_rng(80), 500, 2400, 640, 480, 128, 28.0)
    _k2_check(cuda, data, 28.0, skip=torch.tensor(skip, device=cuda))


def _k3_problem(rng, K, fx=480.0, cx=320.0, cy=240.0):
    """chip_smoke.py check_motion_ba's problem at K rows: 70 % valid, 10 %
    gross outliers, 0.5 px noise, the pose perturbed."""
    X = np.stack([rng.uniform(-6, 6, K), rng.uniform(-4, 4, K), rng.uniform(4, 14, K)], -1)
    w, t = np.array([0.02, -0.05, 0.01]), np.array([0.3, -0.1, 0.2])
    Xc = X @ _rot(w).T + t
    uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    uv[: K // 10] += rng.uniform(40, 120, (K // 10, 2))
    valid = rng.uniform(size=K) < 0.7
    pose0 = np.concatenate([w + [0.01, -0.01, 0.005], t + [0.05, -0.04, 0.06]])
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return ([f32(pose0), f32(uv.reshape(K, 2)), f32(X.reshape(K, 3)), torch.from_numpy(valid)],
            dict(fx=fx, cx=cx, cy=cy, huber_delta=float(np.sqrt(5.991)) / fx))


@pytest.mark.parametrize("case", ["all_iters", "lambda_exit", "K0", "K1025", "K2561", "K7200",
                                  "K12000"])
def test_k3_fused_pass_cases_match_twin(cuda, case):
    """K3 (each CTA of the cluster with its slice of the rows compacted in
    its shared memory: 0 to 1500 rows a CTA from K = 0 to 12000) against
    its twin: rvec 1e-5, t 1e-4, cost within 1 %.
    `all_iters` runs all 10 iterations (ftol = 0); `lambda_exit` starts at
    the optimum with lambda 1e6, so steps are rejected until lambda > 1e8
    stops the loop. The sizes run with ftol = 0 too (all 10 iterations on
    both sides) and with the tolerance exit on, where the iteration counts
    agree within 1 unless rounding decides them: these problems converge in
    two iterations, after which a step changes the float32 cost by a few
    ulps at most, so whether it is accepted (and the exit taken) or
    rejected (lambda doubled, the loop going on) depends on how each side
    rounds its sums. Where the counts differ by more than
    1, the step at which they parted (the shorter count n) must have moved
    the cost on each side by no more than the float32 sum's rounding bound,
    log2(valid rows) ulps, and each side's iterations past n must have moved
    its pose by less than the pose tolerances and its cost by no more than
    that bound. Each tolerance-exit run prints both counts and the twin's
    with its rows in three other orders (run with -s to see them)."""
    K = {"K0": 0, "K1025": 1025, "K2561": 2561, "K7200": 7200, "K12000": 12000}.get(case, 2400)
    args, kw = _k3_problem(np.random.default_rng(30), K)
    kw.update(max_iters=10)
    if case == "lambda_exit":
        conv = k3.motion_ba_lm_reference(*args, **{**kw, "max_iters": 30, "ftol": 0.0})
        args[0] = conv[:6].clone()
        kw.update(init_lambda=1e6)
    args = [a.to(cuda) for a in args]
    runs = [dict(kw, ftol=0.0)] + ([] if case in ("all_iters", "lambda_exit") else [kw])
    for kwr in runs:
        out = k3.motion_ba_lm(*args, **kwr).cpu().numpy()
        ref = k3.motion_ba_lm_reference(*args, **kwr).cpu().numpy()
        np.testing.assert_allclose(out[:3], ref[:3], atol=1e-5)
        np.testing.assert_allclose(out[3:6], ref[3:6], atol=1e-4)
        assert abs(out[6] - ref[6]) <= 0.01 * ref[6] + 1e-10, (out[6], ref[6])
        if kwr.get("ftol") == 0.0 and case != "lambda_exit":
            assert out[7] == ref[7] == 10, (out[7], ref[7])
        elif case == "lambda_exit":
            assert abs(out[7] - ref[7]) <= 1 and out[7] < 10, (out[7], ref[7])
        else:
            orders = [torch.from_numpy(np.random.default_rng(s).permutation(K)).to(cuda)
                      for s in range(3)]
            reordered = [int(k3.motion_ba_lm_reference(args[0], *[a[o] for a in args[1:]],
                                                       **kwr)[7]) for o in orders]
            print(f"K3 {case}: iterations kernel {out[7]:.0f}, twin {ref[7]:.0f}, "
                  f"twin with its rows reordered {reordered}")
            if abs(out[7] - ref[7]) > 1:
                n = int(min(out[7], ref[7]))
                bound = np.ceil(np.log2(max(int(args[3].sum()), 2)))
                for fn, full in ((k3.motion_ba_lm, out), (k3.motion_ba_lm_reference, ref)):
                    at_n, before = [fn(*args, **{**kwr, "max_iters": m}).cpu().numpy()
                                    for m in (n, n - 1)]
                    ulp = np.spacing(np.float32(at_n[6]))
                    assert before[6] - at_n[6] <= bound * ulp, (fn.__name__, n, before, at_n)
                    np.testing.assert_allclose(full[:3], at_n[:3], atol=1e-5)
                    np.testing.assert_allclose(full[3:6], at_n[3:6], atol=1e-4)
                    assert abs(full[6] - at_n[6]) <= bound * ulp, (fn.__name__, full, at_n)


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("K", [2400, 5000])
def test_k2_batched_equals_single_launches(cuda, D, K):
    """K2 over S = 8 problems in one launch (the multi-sequence step's
    shape: leading S on every operand, each problem its own frame and map
    view; K = 5000 bins in two chunks): each row bit-equal to a launch of
    that row alone, one count for the batched call, and each row held to
    its twin by _k2_check's rules. Row 3 passes no point gate and row 5
    no keypoint gate; a per-row `skip` blanks exactly the rows it sets."""
    S, P = 8, 1500
    rows = [_k2_inputs(np.random.default_rng(100 + s), P, K, 640, 480, D, 28.0) for s in range(S)]
    rows[3][1][:] = False
    rows[5][6][:] = False
    args = [torch.from_numpy(np.ascontiguousarray(np.stack([r[i] for r in rows]))).to(cuda)
            for i in range(7)]
    args[2] = args[2].to(torch.bfloat16)
    before = k2.launches
    bk, bd = k2.guided_match_stage1(*args, radius_px=28.0)
    assert k2.launches == before + 1
    rk, rd = k2.guided_match_stage1_reference(*args, radius_px=28.0)
    for s in range(S):
        sk, sd = k2.guided_match_stage1(*[a[s] for a in args], radius_px=28.0)
        assert torch.equal(bk[s], sk) and torch.equal(bd[s], sd), f"row {s} differs from its launch"
        r1k, r1d = k2.guided_match_stage1_reference(*[a[s] for a in args], radius_px=28.0)
        assert torch.equal(rk[s], r1k) and torch.equal(rd[s], r1d)
        _k2_check(cuda, rows[s], 28.0)
    assert bool((bd[3] == 1e9).all()) and bool((bd[5] == 1e9).all())
    skip = torch.tensor([s % 3 == 0 for s in range(S)], device=cuda)
    sk, sd = k2.guided_match_stage1(*args, radius_px=28.0, skip=skip)
    for s in range(S):
        if s % 3 == 0:
            assert bool((sk[s] == 0).all()) and bool((sd[s] == 1e9).all())
        else:
            assert torch.equal(sk[s], bk[s]) and torch.equal(sd[s], bd[s])


@pytest.mark.parametrize("K", [2400, 2401, 12000])
@pytest.mark.parametrize("S", [1, 2, 7, 8])
def test_k3_batched_equals_single_launches(cuda, S, K):
    """K3 over S solves in one launch of S 8-CTA clusters (K = 2401 is no
    multiple of the cluster, so the last CTA's slice is shorter; 12000
    puts 1500 rows in a CTA's shared memory): each row bit-equal to a
    launch of that row alone, one count for the batched call, all S
    clusters co-resident on the card, and each row within the twin's
    rules (rvec 1e-5, t 1e-4, cost 1 %). Twice: with ftol = 0 (all 10
    iterations on both sides) and with the tolerance exit, where the rows
    start at poses perturbed by different amounts and the last row (S >=
    2) has no valid row, so the rows stop after different iteration counts
    (the empty row runs all 10: its cost stays 0 and every step is
    rejected) and its pose must come back unchanged."""
    probs = [_k3_problem(np.random.default_rng(200 + s), K) for s in range(S)]
    for s, (args, _) in enumerate(probs):
        args[0] = args[0] + torch.tensor([0.01, 0.0, -0.01, 0.05, 0.0, 0.02]) * (s % 4) / 2
    if S > 1:
        probs[-1][0][3][:] = False
    args = [torch.stack([p[0][i] for p in probs]).to(cuda) for i in range(4)]
    assert k3.max_active_clusters(K) >= S
    empty = [S - 1] if S > 1 else []
    for ftol in (0.0, None):
        kw = dict(probs[0][1], max_iters=10, **({} if ftol is None else {"ftol": ftol}))
        before = k3.launches
        out = k3.motion_ba_lm(*args, **kw)
        assert k3.launches == before + 1 and out.shape == (S, 8)
        ref = k3.motion_ba_lm_reference(*args, **kw).cpu().numpy()
        for s in range(S):
            one = k3.motion_ba_lm(*[a[s] for a in args], **kw)
            assert torch.equal(out[s], one), f"row {s} differs from its launch (ftol {ftol})"
        out = out.cpu().numpy()
        for s in empty:
            np.testing.assert_array_equal(out[s, :6], args[0][s].cpu().numpy())
            assert out[s, 7] == 10
        for s in set(range(S)) - set(empty):
            np.testing.assert_allclose(out[s, :3], ref[s, :3], atol=1e-5)
            np.testing.assert_allclose(out[s, 3:6], ref[s, 3:6], atol=1e-4)
            assert abs(out[s, 6] - ref[s, 6]) <= 0.01 * ref[s, 6] + 1e-10, (s, out[s, 6], ref[s, 6])
            if ftol == 0.0:
                assert out[s, 7] == ref[s, 7] == 10
        print(f"K3 S={S} K={K} ftol={ftol}: iterations {out[:, 7].astype(int).tolist()}")
        if ftol is None and S > 1:
            assert len(set(out[:, 7].tolist())) > 1, out[:, 7]


def test_k5_batched_equals_single_launches(cuda):
    """K5 over S = 8 problems in one launch (the multi-sequence step's
    shape: a leading S on every operand, each row planned by band_plan on
    its own frame and map view; P = 1000, K = 2400 on 640x480, bands of 4
    keypoint tiles): each row bit-equal to a launch of that row alone, one
    count for the batched call, and each row held to the twin at
    test_k5_run_cases_match_twin's tolerances. Row 7 gates 200 points over
    the whole frame, so its band needs all 5 keypoint tiles and does not
    fit: its K5 row does no work, and the banded stage 1 answers that row
    with K2 (skip per row), each of its rows equal to the stage run on
    that row alone."""
    S = 8
    cases = [_k5_case(np.random.default_rng(300 + s), "inactive") for s in range(S)]
    tiles = cases[0][1]
    data = [list(c[0]) for c in cases]
    keep = np.zeros_like(data[7][1])
    keep[np.random.default_rng(9).choice(len(keep), 200, replace=False)] = True
    data[7][1] = keep
    args = [torch.from_numpy(np.ascontiguousarray(np.stack([d[i] for d in data]))).to(cuda)
            for i in range(7)]
    args[2] = args[2].to(torch.bfloat16)
    plan = matching.band_plan(*args, **tiles)
    assert plan.fits.tolist() == [True] * 7 + [False]
    n_act = torch.where(plan.fits, plan.n_act, torch.zeros_like(plan.n_act)).to(torch.int32)
    kargs = (*plan.k5_args, n_act)
    before = k5.launches
    bk, bd = k5.guided_match_stage1_banded(*kargs, **tiles)
    assert k5.launches == before + 1 and bk.shape == (S, plan.p_sel.shape[1])
    rk, rd = k5.guided_match_stage1_banded_reference(*kargs, **tiles)
    for s in range(S):
        sk, sd = k5.guided_match_stage1_banded(*[a[s] for a in kargs], **tiles)
        assert torch.equal(bk[s], sk) and torch.equal(bd[s], sd), f"row {s} differs from its launch"
        hit = rd[s] < 1e9
        assert float((bd[s] - rd[s]).abs().max()) <= 1e-5
        if s < 7:
            assert int(hit.sum()) > 400
            assert float((bk[s][hit] == rk[s][hit]).float().mean()) >= 0.999
    assert bool((bd[7] == 1e9).all()) and bool((bk[7] == 0).all())
    fk, fd, fell_back = matching._banded_stage1(*args, **tiles)
    assert fell_back.tolist() == [False] * 7 + [True]
    for s in range(S):
        ok, od, ofb = matching._banded_stage1(*[a[s] for a in args], **tiles)
        assert torch.equal(fk[s], ok) and torch.equal(fd[s], od) and bool(ofb) == bool(fell_back[s])
    assert int((fd[7] < 1e9).sum()) > 100  # K2 answered the row that did not fit
