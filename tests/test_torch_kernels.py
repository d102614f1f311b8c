"""The CUDA kernels against their plain twins on a CUDA card, at small
and ragged shapes (the main-path shapes are chip_smoke.py's).

These need a card: each test takes the `cuda` fixture, which skips without
one. On a machine with a card and no JAX, run them without the JAX test
configuration:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances and their reasons are chip_smoke.py's check_* docstrings.
"""

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
        uv_p, gate, obs, ov, kp_uv, kp, kp_ok, starts)]
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
