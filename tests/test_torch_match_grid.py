"""The Python side of kernel K2's cell-binned search (csrc/match_kernel.cu),
on the CPU: the cell grid rule (tests/match_grid_model.py, a float32 model
of the kernel's) and the lexicographic (distance, index) running
best that lets candidates arrive in cell order.

The kernel itself runs only on a card (tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from racing_slam_tpu_torch.ops.kernels import match as k2
from match_grid_model import CELL_CAP, cell_grid, cell_of

torch.set_num_threads(2)


def _grid_case(case, rng):
    """(kp_uv, kp_ok, point uv, radius) for one kind of input."""
    K, P, W, H, r = 2400, 3000, 640.0, 480.0, 28.0
    if case == "720p":
        K, W, H, r = 7200, 1280.0, 720.0, 42.0
    if case == "radius_0.5":
        r = 0.5
    if case == "radius_80":
        r = 80.0
    kp = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1).astype(np.float32)
    ok = rng.uniform(size=K) < 0.95
    src = rng.integers(0, K, P)
    pts = (kp[src] + rng.uniform(-1.0, 1.0, (P, 2)) * r).astype(np.float32)
    if case == "borders":
        # Keypoints and points on cell borders and within an ulp of them.
        lo_u, lo_v, side, nx, ny = cell_grid(kp, ok, r)
        m = rng.integers(1, nx - 1, P)
        b = (lo_u + side * m).astype(np.float32)
        pts[:, 0] = np.where(rng.uniform(size=P) < 0.5, b, np.nextafter(b, np.float32(-1e9)))
        kp[: P // 4, 0] = np.nextafter(pts[: P // 4, 0] + np.float32(r), np.float32(1e9))
        kp[P // 4: P // 2, 0] = pts[P // 4: P // 2, 0] - np.float32(r)
        kp[: P // 2, 1] = pts[: P // 2, 1]
        kp[0], kp[1] = [lo_u, lo_v], [lo_u + side * nx, lo_v + side * ny]  # keep the extent
        ok[:2] = True
    if case == "off_frame":
        pts[: P // 2] += rng.choice([-1.0, 1.0], (P // 2, 2)) * rng.uniform(0, 3 * r, (P // 2, 2))
        pts[P // 2: P // 2 + 50] = -rng.uniform(0, 2 * r, (50, 2))
        pts[-50:] = [W + 5 * r, -5 * r]
    return kp, ok, pts, r


@pytest.mark.parametrize("case", ["random", "borders", "off_frame", "720p", "radius_0.5",
                                  "radius_80"])
def test_cell_grid_puts_every_pair_within_the_radius_in_the_3x3_cells(case):
    """Every (point, gated keypoint) pair that passes the kernel's float32
    pixel gate lies in the point's 3 x 3 cells, with both sides clamped to
    the grid as the kernel clamps them; the grid keeps to its cap."""
    rng = np.random.default_rng(["random", "borders", "off_frame", "720p", "radius_0.5",
                                 "radius_80"].index(case))
    kp, ok, pts, r = _grid_case(case, rng)
    lo_u, lo_v, side, nx, ny = cell_grid(kp, ok, r)
    assert side >= np.float32(r) and 1 <= nx <= CELL_CAP and 1 <= ny <= CELL_CAP
    kx, ky = cell_of(kp[:, 0], lo_u, side, nx), cell_of(kp[:, 1], lo_v, side, ny)
    px, py = cell_of(pts[:, 0], lo_u, side, nx), cell_of(pts[:, 1], lo_v, side, ny)
    du = pts[:, None, 0] - kp[None, :, 0]
    dv = pts[:, None, 1] - kp[None, :, 1]
    r2 = np.float32(r * r)
    passing = (du * du + dv * dv <= r2) & ok[None, :]
    assert passing.sum() > len(pts) // 2
    i, j = np.nonzero(passing)
    assert (np.abs(px[i] - kx[j]) <= 1).all() and (np.abs(py[i] - ky[j]) <= 1).all()
    if case == "off_frame":
        assert ((px == 0) | (px == nx - 1)).sum() > 50  # clamped to the edge cells


def test_cell_grid_without_gated_keypoints_is_none():
    kp = np.zeros((5, 2), np.float32)
    assert cell_grid(kp, np.zeros(5, bool), 28.0) is None


def _pair_distances(uv_p, gate, obs, ov, kp_uv, kp_desc, kp_ok, r):
    """The twin's masked distance of every (point, keypoint) pair, [P, K]."""
    kb = kp_desc.to(torch.bfloat16).float()
    ob = obs.to(torch.bfloat16).float()
    dd = torch.clamp((ob * ob).sum(-1)[:, :, None] + (kb * kb).sum(-1)[None, None, :]
                     - 2.0 * torch.einsum("pod,kd->pok", ob, kb), min=0.0)
    dd = torch.where(ov[:, :, None], dd, torch.tensor(k2.BIG)).min(dim=1).values
    duv = uv_p[:, None, :] - kp_uv[None, :, :]
    ok = ((duv * duv).sum(-1) <= r * r) & gate[:, None] & kp_ok[None, :]
    return torch.where(ok, dd, torch.tensor(k2.BIG)), ok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lexicographic_best_in_shuffled_order_matches_the_twin(seed):
    """Walking each point's passing keypoints in a random order (as cell
    order is, for the kernel) with the rule `d < best or (d == best and k
    < bk)` picks the twin's keypoint and distance, planted exact ties
    included; a strict `d < best` in the same order would not always."""
    rng = np.random.default_rng(seed)
    P, O, D, K, r = 400, 8, 64, 600, 20.0
    kp_uv = np.stack([rng.uniform(0, 320, K), rng.uniform(0, 240, K)], -1).astype(np.float32)
    kp = rng.standard_normal((K, D)).astype(np.float32)
    kp /= np.linalg.norm(kp, axis=-1, keepdims=True)
    for i in range(0, 200, 2):  # exact ties, keypoint 2i+1 a copy of 2i
        kp[i + 1], kp_uv[i + 1] = kp[i], kp_uv[i] + 0.5
    src = rng.integers(0, 200, P)
    obs = kp[src][:, None] + 0.05 * rng.standard_normal((P, O, D)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (
        (kp_uv[src] + rng.uniform(-4, 4, (P, 2))).astype(np.float32), rng.uniform(size=P) < 0.9,
        obs, rng.uniform(size=(P, O)) < 0.7, kp_uv, kp, rng.uniform(size=K) < 0.95)]
    rk, rd = k2.guided_match_stage1_reference(*args, radius_px=r)
    dd, ok = _pair_distances(*args, r)
    strict_differs = 0
    for p in range(P):
        cand = torch.nonzero(ok[p])[:, 0].numpy()
        rng.shuffle(cand)
        best, bk, sbest, sbk = k2.BIG, 0, k2.BIG, 0
        for k in cand:
            d = float(dd[p, k])
            if d < best or (d == best and k < bk):
                best, bk = d, int(k)
            if d < sbest:
                sbest, sbk = d, int(k)
        assert (bk, best) == (int(rk[p]), float(rd[p])), p
        strict_differs += sbk != bk
    assert strict_differs > 0
