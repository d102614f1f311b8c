"""Fixed-capacity SoA world state (port of racing_slam_tpu/slam/state.py).

Keyframes [F], map points [P] with a point-major observation table [P, O],
validity masks instead of compaction. Every mutation is a pure function
that returns new tensors, as in the JAX package, and none reads a value
back to the host. Index tensors are int64.

JAX drops out-of-range scatter indices (`mode="drop"`); on CUDA an
out-of-range index is a device-side assert. The scatters here therefore
write through a sentinel row (`set_drop`): rejected entries target one
extra row that is sliced off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import se3
from ..ops.camera import Camera, project_camera_points, project_with_depth

NO_MATCH = -1
I64 = torch.int64


def as_tensor(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor, or a python scalar filled on the device (torch.tensor of a
    python value would copy it from host memory, a synchronising copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def as_index(i, device) -> torch.Tensor:
    """A python int or 0-d tensor -> [1] int64 index tensor on `device`."""
    return as_tensor(i, I64, device).reshape(1)


def get_row(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] for a python int or 0-d index tensor, without a host read."""
    return x.index_select(0, as_index(i, x.device))[0]


def set_row(x: torch.Tensor, i, v) -> torch.Tensor:
    """x with row i replaced by v (out of place)."""
    v = as_tensor(v, x.dtype, x.device)
    return x.index_put((as_index(i, x.device),), v.unsqueeze(0))


def set_drop(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """x.at[idx].set(vals, mode="drop"): rows with idx outside [0, N) are
    dropped, by writing them to a sentinel row N that is sliced off."""
    N = x.shape[0]
    tgt = torch.where((idx >= 0) & (idx < N), idx, torch.full_like(idx, N)).to(I64)
    ext = torch.cat([x, x[:1]], dim=0)
    return ext.index_put((tgt,), as_tensor(vals, x.dtype, x.device))[:N]


def set_drop2(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor, vals) -> torch.Tensor:
    """x.at[i, j].set(vals, mode="drop") on the first two dims of x."""
    N, M = x.shape[:2]
    ok = (i >= 0) & (i < N) & (j >= 0) & (j < M)
    flat = torch.where(ok, i * M + j, torch.full_like(i, N * M)).to(I64)
    return set_drop(x.reshape(N * M, *x.shape[2:]), flat, vals).reshape(x.shape)


class Features(NamedTuple):
    xy: torch.Tensor  # [K, 2]
    desc: torch.Tensor  # [K, D]
    valid: torch.Tensor  # [K] bool
    score: torch.Tensor  # [K]


class KeyframeStore(NamedTuple):
    rvec: torch.Tensor  # [F, 3]
    t: torch.Tensor  # [F, 3]
    kp_xy: torch.Tensor  # [F, K, 2]
    desc: torch.Tensor  # [F, K, D]
    kp_valid: torch.Tensor  # [F, K] bool
    matches: torch.Tensor  # [F, K] int64 map slot or -1
    valid: torch.Tensor  # [F] bool
    frame_index: torch.Tensor  # [F] int64

    @staticmethod
    def create(F: int, K: int, D: int, device=None) -> "KeyframeStore":
        z = dict(device=device)
        return KeyframeStore(
            rvec=torch.zeros((F, 3), **z),
            t=torch.zeros((F, 3), **z),
            kp_xy=torch.zeros((F, K, 2), **z),
            desc=torch.zeros((F, K, D), **z),
            kp_valid=torch.zeros((F, K), dtype=torch.bool, **z),
            matches=torch.full((F, K), NO_MATCH, dtype=I64, **z),
            valid=torch.zeros((F,), dtype=torch.bool, **z),
            frame_index=torch.full((F,), -1, dtype=I64, **z),
        )

    def pose(self, f) -> torch.Tensor:
        return se3.pose_matrix(get_row(self.rvec, f), get_row(self.t, f))

    def num_matches(self, f) -> torch.Tensor:
        return torch.sum((get_row(self.matches, f) >= 0) & get_row(self.kp_valid, f))


class MapState(NamedTuple):
    pos: torch.Tensor  # [P, 3]
    color: torch.Tensor  # [P]
    valid: torch.Tensor  # [P] bool
    obs_kf: torch.Tensor  # [P, O] int64 keyframe slot
    obs_kp: torch.Tensor  # [P, O] int64 keypoint index
    obs_valid: torch.Tensor  # [P, O] bool

    @staticmethod
    def create(P: int, O: int, device=None) -> "MapState":
        z = dict(device=device)
        return MapState(
            pos=torch.zeros((P, 3), **z),
            color=torch.zeros((P,), **z),
            valid=torch.zeros((P,), dtype=torch.bool, **z),
            obs_kf=torch.zeros((P, O), dtype=I64, **z),
            obs_kp=torch.zeros((P, O), dtype=I64, **z),
            obs_valid=torch.zeros((P, O), dtype=torch.bool, **z),
        )

    def num_points(self) -> torch.Tensor:
        return torch.sum(self.valid)

    def observed_by(self, kf_slot) -> torch.Tensor:
        """[P] bool: point has an observation in keyframe `kf_slot`."""
        return torch.any((self.obs_kf == kf_slot) & self.obs_valid, dim=-1)

    def observation_descriptors(self, kfs: KeyframeStore) -> tuple[torch.Tensor, torch.Tensor]:
        """Stored descriptors of all observations: [P, O, D], [P, O]."""
        return kfs.desc[self.obs_kf, self.obs_kp], self.obs_valid & self.valid[:, None]

    def ba_point_selection(self, kf_slot, budget: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Compact the BA point set: slots observed by `kf_slot` first."""
        return self.ba_point_selection_mask(self.observed_by(kf_slot) & self.valid, budget)

    def ba_point_selection_mask(
        self, point_in: torch.Tensor, budget: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """[budget] slots of the in-problem points, most observed first
        (stable order); returns (sel, sel_ok)."""
        O = self.obs_valid.shape[1]
        n_obs = torch.sum(self.obs_valid, dim=-1)
        rank = torch.where(point_in, O - n_obs, torch.full_like(n_obs, 2 * O))
        sel = torch.argsort(rank, stable=True)[:budget]
        return sel, point_in[sel]

    def observed_by_any(self, kf_slots: torch.Tensor) -> torch.Tensor:
        """[P] bool: observed in ANY of `kf_slots` [W] (entries < 0 ignored)."""
        slots = torch.where(kf_slots >= 0, kf_slots, torch.full_like(kf_slots, -2))
        eq = self.obs_kf[..., None] == slots
        return torch.any(eq & self.obs_valid[..., None], dim=-1).any(dim=-1)


class SlamState(NamedTuple):
    kfs: KeyframeStore
    map: MapState
    num_kf: torch.Tensor  # int64 0-d
    last_kf_slot: torch.Tensor  # int64 0-d
    last_rvec: torch.Tensor  # [3]
    last_t: torch.Tensor  # [3]
    prev_rvec: torch.Tensor  # [3]
    prev_t: torch.Tensor  # [3]
    last_feat: Features
    last_matches: torch.Tensor  # [K] int64
    frame_count: torch.Tensor  # int64 0-d
    obs_desc: torch.Tensor  # [P, O, D] bf16 cache of kfs.desc[obs_kf, obs_kp]
    reproj_px: torch.Tensor  # f32 0-d
    arch_rvec: torch.Tensor  # [A, 3]
    arch_t: torch.Tensor  # [A, 3]
    arch_frame_index: torch.Tensor  # [A] int64 (-1 = empty)
    arch_count: torch.Tensor  # int64 0-d, may exceed A
    last_inliers: torch.Tensor  # int64 0-d

    @staticmethod
    def create(F: int, P: int, O: int, K: int, D: int, A: int = 512, device=None) -> "SlamState":
        z = dict(device=device)
        zero = torch.zeros((), dtype=I64, **z)
        return SlamState(
            kfs=KeyframeStore.create(F, K, D, device),
            map=MapState.create(P, O, device),
            num_kf=zero.clone(),
            last_kf_slot=zero.clone(),
            last_rvec=torch.zeros(3, **z),
            last_t=torch.zeros(3, **z),
            prev_rvec=torch.zeros(3, **z),
            prev_t=torch.zeros(3, **z),
            last_feat=Features(
                xy=torch.zeros((K, 2), **z),
                desc=torch.zeros((K, D), **z),
                valid=torch.zeros((K,), dtype=torch.bool, **z),
                score=torch.zeros((K,), **z),
            ),
            last_matches=torch.full((K,), NO_MATCH, dtype=I64, **z),
            frame_count=zero.clone(),
            obs_desc=torch.zeros((P, O, D), dtype=torch.bfloat16, **z),
            reproj_px=torch.full((), -1.0, **z),
            arch_rvec=torch.zeros((A, 3), **z),
            arch_t=torch.zeros((A, 3), **z),
            arch_frame_index=torch.full((A,), -1, dtype=I64, **z),
            arch_count=zero.clone(),
            last_inliers=zero.clone(),
        )


# ---------------------------------------------------------------------------
# Mutations (pure; no host reads)
# ---------------------------------------------------------------------------


def write_keyframe(kfs: KeyframeStore, slot, rvec, t, feat: Features, matches,
                   frame_index) -> KeyframeStore:
    """Write a frame into keyframe slot `slot` (int or 0-d tensor)."""
    return kfs._replace(
        rvec=set_row(kfs.rvec, slot, rvec),
        t=set_row(kfs.t, slot, t),
        kp_xy=set_row(kfs.kp_xy, slot, feat.xy),
        desc=set_row(kfs.desc, slot, feat.desc),
        kp_valid=set_row(kfs.kp_valid, slot, feat.valid),
        matches=set_row(kfs.matches, slot, matches),
        valid=set_row(kfs.valid, slot, True),
        frame_index=set_row(kfs.frame_index, slot, frame_index),
    )


def allocate_point_slots(map_valid: torch.Tensor, n_cand: int) -> torch.Tensor:
    """[n_cand] slot ids, free slots first (callers AND with slot-is-free)."""
    return torch.argsort(map_valid.to(torch.int32), stable=True)[:n_cand]


def create_points(
    m: MapState,
    positions: torch.Tensor,  # [C, 3]
    cand_valid: torch.Tensor,  # [C]
    kf_a,  # keyframe slot of the first observation (int or 0-d)
    kf_b,  # keyframe slot of the second observation
    kp_a: torch.Tensor,  # [C]
    kp_b: torch.Tensor,  # [C]
    colors: torch.Tensor,  # [C]
    kfs: KeyframeStore,
) -> tuple[MapState, KeyframeStore, torch.Tensor, torch.Tensor]:
    """Allocate a slot per valid candidate, write it, register its two
    observations and wire both frames' match slots. Returns
    (map, kfs, slots[C], created[C])."""
    C = positions.shape[0]
    P = m.valid.shape[0]
    O = m.obs_kf.shape[1]
    dev = positions.device
    order = torch.argsort((~cand_valid).to(torch.int32), stable=True)
    inv_order = torch.argsort(order)
    slots = allocate_point_slots(m.valid, C)[inv_order]
    created = cand_valid & ~m.valid[slots]
    target = torch.where(created, slots, torch.full_like(slots, P))

    kf_a = as_tensor(kf_a, I64, dev)
    kf_b = as_tensor(kf_b, I64, dev)
    zeros_i = torch.zeros((C, O - 2), dtype=I64, device=dev)
    obs_kf_new = torch.cat([kf_a.expand(C, 1), kf_b.expand(C, 1), zeros_i], dim=-1)
    obs_kp_new = torch.cat([kp_a[:, None].to(I64), kp_b[:, None].to(I64), zeros_i], dim=-1)
    obs_valid_new = torch.cat(
        [torch.ones((C, 2), dtype=torch.bool, device=dev),
         torch.zeros((C, O - 2), dtype=torch.bool, device=dev)], dim=-1
    )
    m = m._replace(
        pos=set_drop(m.pos, target, positions),
        color=set_drop(m.color, target, colors),
        valid=set_drop(m.valid, target, True),
        obs_kf=set_drop(m.obs_kf, target, obs_kf_new),
        obs_kp=set_drop(m.obs_kp, target, obs_kp_new),
        obs_valid=set_drop(m.obs_valid, target, obs_valid_new),
    )
    K = kfs.matches.shape[1]
    kp_a_t = torch.where(created, kp_a.to(I64), torch.full_like(slots, K))
    kp_b_t = torch.where(created, kp_b.to(I64), torch.full_like(slots, K))
    matches = set_drop2(kfs.matches, kf_a.expand(C), kp_a_t, slots)
    matches = set_drop2(matches, kf_b.expand(C), kp_b_t, slots)
    return m, kfs._replace(matches=matches), slots, created


def add_associations(
    m: MapState,
    kf_slot,
    point_idx: torch.Tensor,  # [K] map slot per keypoint (or -1)
    assoc_valid: torch.Tensor,  # [K] bool
    kf_frame_index: torch.Tensor | None = None,  # [F]
    policy: str = "replace_oldest",
) -> MapState:
    """Register observation (kf_slot, k) on each matched point; a full table
    replaces its oldest observation ("replace_oldest") or drops the new one
    ("drop_newest"). The first invalid slot is always taken first."""
    K = point_idx.shape[0]
    P, O = m.obs_valid.shape
    dev = point_idx.device
    pid = torch.clamp(point_idx, 0, P - 1).to(I64)
    minus1 = torch.full_like(m.obs_kf, -1)
    if kf_frame_index is None:
        age = torch.where(m.obs_valid, torch.arange(O, device=dev)[None, :].expand(P, O), minus1)
    else:
        age = torch.where(m.obs_valid, kf_frame_index[torch.clamp(m.obs_kf, min=0)], minus1)
    cursor = torch.argmin(age, dim=-1)[pid]
    ok = assoc_valid & (point_idx >= 0)
    if policy == "drop_newest":
        ok = ok & torch.any(~m.obs_valid, dim=-1)[pid]
    pid_t = torch.where(ok, pid, torch.full_like(pid, P))
    cur_t = torch.where(ok, cursor, torch.full_like(cursor, O))
    kf = as_tensor(kf_slot, I64, dev).expand(K)
    return m._replace(
        obs_kf=set_drop2(m.obs_kf, pid_t, cur_t, kf),
        obs_kp=set_drop2(m.obs_kp, pid_t, cur_t, torch.arange(K, device=dev)),
        obs_valid=set_drop2(m.obs_valid, pid_t, cur_t, True),
    )


def remove_points(m: MapState, kfs: KeyframeStore, remove: torch.Tensor
                  ) -> tuple[MapState, KeyframeStore]:
    """Invalidate points and scrub every keyframe match slot naming them."""
    m = m._replace(valid=m.valid & ~remove, obs_valid=m.obs_valid & ~remove[:, None])
    ref = kfs.matches
    stale = (ref >= 0) & remove[torch.clamp(ref, min=0)]
    return m, kfs._replace(matches=torch.where(stale, torch.full_like(ref, NO_MATCH), ref))


def _obs_mean_errors(cam: Camera, pos, obs_kf, obs_kp, obs_w, kfs: KeyframeStore):
    """Mean reprojection error (px) per row over its counted observations."""
    R = se3.exp_so3(kfs.rvec)  # [F, 3, 3], once per keyframe
    Xc = torch.einsum("noij,nj->noi", R[obs_kf], pos) + kfs.t[obs_kf]
    uv = project_camera_points(cam, Xc)
    err = torch.linalg.norm(uv - kfs.kp_xy[obs_kf, obs_kp], dim=-1)
    n = torch.sum(obs_w, dim=-1)
    mean_err = torch.sum(torch.where(obs_w, err, torch.zeros_like(err)), dim=-1) / torch.clamp(
        n, min=1
    )
    return mean_err, n > 0


def point_reprojection_errors(cam: Camera, m: MapState, kfs: KeyframeStore):
    """(mean_err[P], has_obs[P]) over each point's observations."""
    return _obs_mean_errors(cam, m.pos, m.obs_kf, m.obs_kp, m.obs_valid & m.valid[:, None], kfs)


def point_reprojection_errors_sel(cam: Camera, m: MapState, kfs: KeyframeStore,
                                  sel: torch.Tensor, sel_ok: torch.Tensor):
    """point_reprojection_errors over a compacted candidate set [C]."""
    return _obs_mean_errors(
        cam, m.pos[sel], m.obs_kf[sel], m.obs_kp[sel],
        m.obs_valid[sel] & (m.valid[sel] & sel_ok)[:, None], kfs,
    )


def keyframe_reprojection_error(cam: Camera, m: MapState, kfs: KeyframeStore) -> torch.Tensor:
    """Mean px error over all keyframe match slots (monitoring metric)."""
    pid = torch.clamp(kfs.matches, min=0)
    ok = (kfs.matches >= 0) & kfs.kp_valid & kfs.valid[:, None] & m.valid[pid]
    poses = se3.pose_matrix(kfs.rvec, kfs.t)  # [F, 4, 4]
    uv, _ = project_with_depth(cam, poses, m.pos[pid])  # [F, K, 2]
    err = torch.linalg.norm(uv - kfs.kp_xy, dim=-1)
    n = torch.sum(ok)
    return torch.sum(torch.where(ok, err, torch.zeros_like(err))) / torch.clamp(n, min=1)
