"""The SLAM pipeline: two-view bootstrap + per-frame tracking (port of
racing_slam_tpu/slam/pipeline.py).

A tracking step runs extraction (kernel K1), a constant-velocity (or
constant-position) pose prediction, a guided map->frame match (K2) and a
motion-only BA (K3), a second guided match and motion BA, and the keyframe
decision; a keyframe commit adds associations, triangulates against the
last keyframe, runs the commit BA (K4), culls points above 3 px and
refreshes the observation-descriptor cache.

Where the JAX package branches on device data with lax.cond, the port
decides per site:

- the commit (pipeline.py:586): a host branch. It is the one host read of
  a tracking frame: is_kf and the inlier count come back together in one
  `.tolist()`, and the driver's loss detection reuses the inlier count.
- the cull fallback (pipeline.py:330): masked compute. Both the compacted
  and the full [P, O] sweep run on the device and `torch.where` picks one,
  so a commit adds no host read.
- the per-slot `active` cond of the batched scan (pipeline.py:680-687): a
  Python loop over the frames of the batch; there are no padding slots.
- the reprojection monitor: a host branch on the same is_kf read, or a
  masked update when it runs every N frames.

The slice covers the reference commit shape (`local_ba_window=1`) without
periodic refinement; the configuration values of later slices raise
NotImplementedError when the driver is built.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..ops import se3
from ..ops.ba import HUBER_DELTA, BAProblem, motion_ba, structure_ba
from ..ops.camera import Camera, project_with_depth
from ..ops.image import bilinear_sample
from ..ops.matching import match_map_to_frame, unmatched_mask
from ..ops.ransac import estimate_relative_pose
from ..ops.triangulation import triangulate_points
from .config import SlamConfig
from .frontend import ClassicalFrontend
from .state import (
    I64,
    Features,
    SlamState,
    add_associations,
    create_points,
    get_row,
    keyframe_reprojection_error,
    point_reprojection_errors,
    point_reprojection_errors_sel,
    remove_points,
    set_drop,
    write_keyframe,
)


class StepInfo(NamedTuple):
    """Per-frame diagnostics. `is_keyframe` and `n_inliers` are host values
    (the step reads them back anyway); the rest stay on the device."""

    rvec: torch.Tensor
    t: torch.Tensor
    n_matches_kf: torch.Tensor
    n_matches_total: torch.Tensor
    n_last_kf_matches: torch.Tensor
    is_keyframe: bool
    n_points: torch.Tensor
    n_keyframes: torch.Tensor
    reproj_error_px: torch.Tensor
    n_inliers: int


# Configuration values of later slices (ROADMAP.md, "Slices of the port").
_LATER = {
    "local_ba_window": "slice 2 (window_ba / full_ba / refinement)",
    "refine_every_frames": "slice 2 (window_ba / full_ba / refinement)",
    "pose_prediction": "slice 3 (adaptive / essential-matrix prediction)",
    "essential_matrix_estimation": "slice 3 (adaptive / essential-matrix prediction)",
    "matching_backend": "slice 4 (banded matcher + kernel K5)",
    "matcher": "slice 5 (learned path + kernel K6)",
    "frontend": "slice 5 (learned path + kernel K6)",
}


def check_slice_config(cfg: SlamConfig, frontend=None) -> None:
    """Raise NotImplementedError for every configuration value outside the
    ported slice, naming the slice of ROADMAP.md that brings it.

    The `*_backend` fields choose between XLA and Pallas in the JAX package.
    The port has no such choice: each kernel wrapper runs its CUDA kernel for
    CUDA tensors and its plain twin for CPU tensors, so only "auto" (and
    "banded", a later slice) is accepted."""
    for field in ("matching_backend", "ba_backend", "frontend_backend"):
        value = getattr(cfg, field)
        if value != "auto" and not (field == "matching_backend" and value == "banded"):
            raise ValueError(f"{field}={value!r}: the port chooses kernel or twin by "
                             "the tensors' device; only 'auto' is accepted")
    bad = []
    if cfg.local_ba_window > 1:
        bad.append(("local_ba_window", cfg.local_ba_window))
    if cfg.refine_every_frames > 0:
        bad.append(("refine_every_frames", cfg.refine_every_frames))
    if cfg.pose_prediction == "adaptive":
        bad.append(("pose_prediction", cfg.pose_prediction))
    if cfg.essential_matrix_estimation:
        bad.append(("essential_matrix_estimation", True))
    if cfg.matching_backend == "banded":
        bad.append(("matching_backend", cfg.matching_backend))
    if cfg.matcher == "lightglue":
        bad.append(("matcher", cfg.matcher))
    if frontend is not None and not isinstance(frontend, ClassicalFrontend):
        bad.append(("frontend", type(frontend).__name__))
    if bad:
        raise NotImplementedError(
            "not ported yet: "
            + "; ".join(f"{k}={v!r} comes with {_LATER[k]}" for k, v in bad)
        )


def _huber(cfg: SlamConfig, cam: Camera) -> float:
    return HUBER_DELTA / cam.fx if cfg.huber_mode == "pixel" else HUBER_DELTA


def _point_matched_mask(P: int, matches: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[P] bool: map slots referenced by the frame's match array."""
    tgt = torch.where(valid & (matches >= 0), matches, torch.full_like(matches, P))
    return set_drop(torch.zeros((P,), dtype=torch.bool, device=matches.device), tgt, True)


def _commit_keyframe(
    state: SlamState,
    img: torch.Tensor,
    feat: Features,
    rvec: torch.Tensor,
    t: torch.Tensor,
    matches: torch.Tensor,
    *,
    cam: Camera,
    cfg: SlamConfig,
    matcher,
) -> SlamState:
    """The keyframe path: eviction + archive, associations, triangulation,
    commit BA (one free camera), cull and obs-descriptor refresh."""
    F = cfg.max_keyframes
    kfs, m = state.kfs, state.map
    dev = rvec.device
    last_slot = state.last_kf_slot

    # Fill free slots first; at capacity evict the OLDEST keyframe, archiving
    # its pose (the archive write is dropped when nothing is evicted).
    big = torch.full_like(kfs.frame_index, torch.iinfo(I64).max)
    oldest = torch.argmin(torch.where(kfs.valid, kfs.frame_index, big))
    slot = torch.where(state.num_kf < F, state.num_kf, oldest)
    A = state.arch_frame_index.shape[0]
    evict = state.num_kf >= F
    aidx = torch.where(evict, state.arch_count, torch.full_like(state.arch_count, A)).reshape(1)
    arch_rvec = set_drop(state.arch_rvec, aidx, get_row(kfs.rvec, oldest)[None])
    arch_t = set_drop(state.arch_t, aidx, get_row(kfs.t, oldest)[None])
    arch_fi = set_drop(state.arch_frame_index, aidx, get_row(kfs.frame_index, oldest)[None])
    arch_count = state.arch_count + evict.to(I64)

    # Scrub observations of the evicted slot; drop points left unobserved.
    evicted_obs = m.observed_by(slot) & m.valid
    m = m._replace(obs_valid=m.obs_valid & (m.obs_kf != slot))
    orphan = m.valid & ~torch.any(m.obs_valid, dim=-1)
    m, kfs = remove_points(m, kfs, orphan)

    match_ok = (matches >= 0) & feat.valid
    kfs = write_keyframe(kfs, slot, rvec, t, feat,
                         torch.where(match_ok, matches, torch.full_like(matches, -1)),
                         state.frame_count)
    m = add_associations(m, slot, matches, match_ok, kfs.frame_index, policy=cfg.obs_policy)

    K = feat.xy.shape[0]
    new_slots = new_created = None
    if cfg.triangulate_points:
        last_xy = get_row(kfs.kp_xy, last_slot)
        fm = matcher(get_row(kfs.desc, last_slot), last_xy, get_row(kfs.kp_valid, last_slot),
                     feat.desc, feat.xy, feat.valid)
        un = unmatched_mask(fm, get_row(kfs.matches, last_slot) >= 0,
                            get_row(kfs.matches, slot) >= 0)
        uv1 = last_xy[fm.train_idx]
        pose1 = se3.pose_matrix(get_row(kfs.rvec, last_slot), get_row(kfs.t, last_slot))
        tri = triangulate_points(cam, pose1, se3.pose_matrix(rvec, t), uv1, feat.xy, mask=un,
                                 max_reproj_px=cfg.triangulation_reproj_px)
        colors = bilinear_sample(img, feat.xy)
        m, kfs, new_slots, new_created = create_points(
            m, tri.points, tri.valid, last_slot, slot, fm.train_idx,
            torch.arange(K, device=dev), colors, kfs,
        )

    P = m.valid.shape[0]
    if cfg.bundle_adjust:
        # Reference shape: only the new keyframe free, the points it sees
        # free, compacted to <= Pc slots (kernel K4).
        Pc = min(P, cfg.ba_commit_budget or -(-K // 128) * 128)
        sel, sel_ok = m.ba_point_selection(slot, Pc)
        obs_kf = m.obs_kf[sel]
        obs_kp = m.obs_kp[sel]
        prob = BAProblem(
            cam_rvec=kfs.rvec,
            cam_t=kfs.t,
            points=m.pos[sel],
            obs_cam=obs_kf,
            obs_uv=kfs.kp_xy[obs_kf, obs_kp],
            obs_valid=m.obs_valid[sel] & sel_ok[:, None],
            cam_free=torch.arange(F, device=dev) == slot,
            cam_in_problem=kfs.valid,
            point_free=sel_ok,
            point_in_problem=sel_ok,
        )
        res = structure_ba(cam, prob, slot, max_iters=cfg.ba_iters,
                           huber_delta=_huber(cfg, cam))
        pos = set_drop(m.pos, torch.where(sel_ok, sel, torch.full_like(sel, P)), res.points)
        kfs = kfs._replace(rvec=res.cam_rvec, t=res.cam_t)
        m = m._replace(pos=pos)
        rvec = get_row(res.cam_rvec, slot)
        t = get_row(res.cam_t, slot)

    if cfg.cull_points:
        # Incremental-exact cull over the points whose error inputs changed
        # (observed by the newest keyframe, or losing an observation to the
        # eviction). Masked compute in place of the JAX lax.cond: the exact
        # full sweep runs too and is taken when candidates overflow.
        newest = torch.argsort(
            torch.where(kfs.valid, -kfs.frame_index, torch.full_like(kfs.frame_index, 1 << 30)),
            stable=True,
        )[:1]
        cand = (evicted_obs | m.observed_by_any(newest)) & m.valid
        Cb = min(P, cfg.cull_budget)
        csel, csel_ok = m.ba_point_selection_mask(cand, Cb)
        err_c, has_c = point_reprojection_errors_sel(cam, m, kfs, csel, csel_ok)
        bad = csel_ok & has_c & (err_c > cfg.cull_reproj_px)
        rm_compact = set_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                              torch.where(bad, csel, torch.full_like(csel, P)), True)
        err_f, has_f = point_reprojection_errors(cam, m, kfs)
        rm_full = m.valid & has_f & (err_f > cfg.cull_reproj_px)
        remove = torch.where(torch.sum(cand) <= Cb, rm_compact, rm_full)
        m, kfs = remove_points(m, kfs, remove)

    # Refresh the obs-descriptor cache rows whose observation table changed:
    # tracked associations and created points.
    touched = torch.where(match_ok, matches, torch.full_like(matches, P))
    if new_slots is not None:
        touched = torch.cat([touched, torch.where(new_created, new_slots,
                                                  torch.full_like(new_slots, P))])
    safe = torch.clamp(touched, max=P - 1)
    drows = kfs.desc[m.obs_kf[safe], m.obs_kp[safe]].to(torch.bfloat16)
    obs_desc = set_drop(state.obs_desc, touched, drows)

    return state._replace(
        kfs=kfs,
        map=m,
        num_kf=torch.clamp(state.num_kf + 1, max=F),
        last_kf_slot=slot,
        last_rvec=rvec,
        last_t=t,
        obs_desc=obs_desc,
        arch_rvec=arch_rvec,
        arch_t=arch_t,
        arch_frame_index=arch_fi,
        arch_count=arch_count,
    )


def slam_step(
    state: SlamState,
    img: torch.Tensor,
    mask: torch.Tensor | None,
    *,
    cam: Camera,
    cfg: SlamConfig,
    frontend: ClassicalFrontend,
) -> tuple[SlamState, StepInfo]:
    """One tracking step. `img` is an [H, W] uint8 or float32 frame on the
    state's device. Makes exactly one host read (is_kf + inlier count)."""
    P = cfg.map_capacity
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) * (1.0 / 255.0)
    feat = frontend.extract(img, mask)
    last_slot = state.last_kf_slot

    if cfg.pose_prediction == "constant_velocity":
        # T_pred = (T_last inv(T_prev)) T_last.
        T_last = se3.pose_matrix(state.last_rvec, state.last_t)
        T_prev = se3.pose_matrix(state.prev_rvec, state.prev_t)
        rvec, t = se3.rt_from_matrix(T_last @ se3.inverse(T_prev) @ T_last)
    elif cfg.pose_prediction == "constant_position":
        rvec, t = state.last_rvec, state.last_t
    else:
        check_slice_config(cfg)
        raise ValueError(f"unknown pose_prediction {cfg.pose_prediction!r}")

    huber = _huber(cfg, cam)
    obs_dvalid = state.map.obs_valid & state.map.valid[:, None]
    K = feat.xy.shape[0]
    no_kp_matched = torch.zeros((K,), dtype=torch.bool, device=img.device)
    no_pt_matched = torch.zeros((P,), dtype=torch.bool, device=img.device)
    match_kw = dict(max_distance=frontend.max_distance, radius_px=cfg.match_radius_px)

    # Match the last keyframe's points, then optimise the pose.
    filt = state.map.observed_by(last_slot) & state.map.valid
    mm1 = match_map_to_frame(
        cam, se3.pose_matrix(rvec, t), state.map.pos, filt, state.obs_desc, obs_dvalid,
        feat.xy, feat.desc, feat.valid, no_kp_matched, no_pt_matched, **match_kw,
    )
    matches = torch.where(mm1.valid, mm1.point_idx, torch.full_like(mm1.point_idx, -1))
    n_kf_matches = torch.sum(matches >= 0)

    def optimise(rvec, t, matches):
        if not cfg.optimize_pose:
            return rvec, t
        res = motion_ba(cam, rvec, t, feat.xy, state.map.pos[torch.clamp(matches, min=0)],
                        matches >= 0, max_iters=cfg.motion_ba_iters, huber_delta=huber)
        return res.rvec, res.t

    rvec, t = optimise(rvec, t, matches)

    # Match the whole map (keypoints and points not matched yet), optimise.
    mm2 = match_map_to_frame(
        cam, se3.pose_matrix(rvec, t), state.map.pos, state.map.valid, state.obs_desc,
        obs_dvalid, feat.xy, feat.desc, feat.valid, matches >= 0,
        _point_matched_mask(P, matches, feat.valid), **match_kw,
    )
    matches = torch.where(mm2.valid & (matches < 0), mm2.point_idx, matches)
    rvec, t = optimise(rvec, t, matches)

    # Keyframe decision + post-solve inliers (the loss signal).
    n_total = torch.sum((matches >= 0) & feat.valid)
    n_last = state.kfs.num_matches(last_slot)
    is_kf = n_total < cfg.keyframe_match_ratio * n_last
    uv_m, depth_m = project_with_depth(cam, se3.pose_matrix(rvec, t),
                                       state.map.pos[torch.clamp(matches, min=0)])
    reproj_m = torch.linalg.norm(uv_m - feat.xy, dim=-1)
    n_inliers = torch.sum((matches >= 0) & feat.valid & (depth_m > 0.0)
                          & (reproj_m < cfg.inlier_px))
    if cfg.min_commit_inliers:
        is_kf = is_kf | (n_inliers < cfg.min_commit_inliers)

    state = state._replace(
        last_rvec=rvec, last_t=t, prev_rvec=state.last_rvec, prev_t=state.last_t,
        last_feat=feat, last_matches=matches, last_inliers=n_inliers,
    )
    # The frame's one host read.
    is_kf_h, n_inl_h = torch.stack([is_kf.to(I64), n_inliers]).tolist()
    if is_kf_h:
        state = _commit_keyframe(state, img, feat, rvec, t, matches, cam=cam, cfg=cfg,
                                 matcher=frontend.matcher)
    state = state._replace(frame_count=state.frame_count + 1)

    every = cfg.reproj_monitor_every
    if every == 1 or (every == 0 and is_kf_h):
        state = state._replace(reproj_px=keyframe_reprojection_error(cam, state.map, state.kfs))
    elif every > 1:
        due = (state.frame_count % every == 0) | is_kf
        state = state._replace(reproj_px=torch.where(
            due, keyframe_reprojection_error(cam, state.map, state.kfs), state.reproj_px))

    info = StepInfo(
        rvec=state.last_rvec,
        t=state.last_t,
        n_matches_kf=n_kf_matches,
        n_matches_total=n_total,
        n_last_kf_matches=n_last,
        is_keyframe=bool(is_kf_h),
        n_points=state.map.num_points(),
        n_keyframes=state.num_kf,
        reproj_error_px=state.reproj_px,
        n_inliers=int(n_inl_h),
    )
    return state, info


# ---------------------------------------------------------------------------
# Two-view bootstrap
# ---------------------------------------------------------------------------


class InitAttempt(NamedTuple):
    pose: torch.Tensor  # [4, 4] relative pose ref->query
    n_triangulated: torch.Tensor
    match_train: torch.Tensor  # [K]
    match_valid: torch.Tensor  # [K] bool


def try_initialize(
    ref_feat: Features,
    query_feat: Features,
    generator: torch.Generator | None,
    *,
    cam: Camera,
    cfg: SlamConfig,
    matcher,
    uniforms: torch.Tensor | None = None,
) -> InitAttempt:
    """One pairing attempt: match, RANSAC pose, count clean triangulations."""
    fm = matcher(ref_feat.desc, ref_feat.xy, ref_feat.valid,
                 query_feat.desc, query_feat.xy, query_feat.valid)
    uv1 = ref_feat.xy[fm.train_idx]
    est = estimate_relative_pose(cam, uv1, query_feat.xy, fm.valid, generator,
                                 num_hypotheses=cfg.init_ransac_hypotheses,
                                 threshold_px=cfg.ransac_threshold_px, uniforms=uniforms)
    eye = torch.eye(4, dtype=torch.float32, device=uv1.device)
    tri = triangulate_points(cam, eye, est.pose, uv1, query_feat.xy, mask=fm.valid,
                             max_reproj_px=cfg.triangulation_reproj_px)
    return InitAttempt(pose=est.pose, n_triangulated=torch.sum(tri.valid),
                       match_train=fm.train_idx, match_valid=fm.valid)


def commit_initialization(
    state: SlamState,
    ref_feat: Features,
    query_feat: Features,
    ref_img: torch.Tensor,
    query_pose: torch.Tensor,
    match_train: torch.Tensor,
    match_valid: torch.Tensor,
    ref_index: int,
    query_index: int,
    *,
    cam: Camera,
    cfg: SlamConfig,
) -> SlamState:
    """Accept an initialisation: triangulate, create points, BA {ref frozen,
    query free, points free} (kernel K4), rescale to unit baseline."""
    F = cfg.max_keyframes
    kfs, m = state.kfs, state.map
    dev = query_pose.device
    K = query_feat.xy.shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    if ref_img.dtype == torch.uint8:
        ref_img = ref_img.to(torch.float32) * (1.0 / 255.0)
    rvec_q, t_q = se3.rt_from_matrix(query_pose)
    uv1 = ref_feat.xy[match_train]
    tri = triangulate_points(cam, eye, query_pose, uv1, query_feat.xy, mask=match_valid,
                             max_reproj_px=cfg.triangulation_reproj_px)
    no_match = torch.full((K,), -1, dtype=I64, device=dev)
    zeros3 = torch.zeros(3, device=dev)
    kfs = write_keyframe(kfs, 0, zeros3, zeros3, ref_feat, no_match, ref_index)
    kfs = write_keyframe(kfs, 1, rvec_q, t_q, query_feat, no_match, query_index)
    colors = bilinear_sample(ref_img, uv1)
    m, kfs, _, _ = create_points(m, tri.points, tri.valid, 0, 1, match_train,
                                 torch.arange(K, device=dev), colors, kfs)

    P = m.valid.shape[0]
    Pc = min(P, -(-K // 128) * 128)
    sel, sel_ok = m.ba_point_selection(1, Pc)
    obs_kf = m.obs_kf[sel]
    obs_kp = m.obs_kp[sel]
    prob = BAProblem(
        cam_rvec=kfs.rvec,
        cam_t=kfs.t,
        points=m.pos[sel],
        obs_cam=obs_kf,
        obs_uv=kfs.kp_xy[obs_kf, obs_kp],
        obs_valid=m.obs_valid[sel] & sel_ok[:, None],
        cam_free=torch.arange(F, device=dev) == 1,
        cam_in_problem=kfs.valid,
        point_free=sel_ok,
        point_in_problem=sel_ok,
    )
    res = structure_ba(cam, prob, 1, max_iters=cfg.ba_iters, huber_delta=_huber(cfg, cam))
    kfs = kfs._replace(rvec=res.cam_rvec, t=res.cam_t)
    m = m._replace(pos=set_drop(m.pos, torch.where(sel_ok, sel, torch.full_like(sel, P)),
                                res.points))

    # Rescale to unit baseline.
    scale = 1.0 / (torch.linalg.norm(kfs.t[1] - kfs.t[0]) + 1e-12)
    kfs = kfs._replace(t=torch.cat([kfs.t[:1], kfs.t[1:2] * scale, kfs.t[2:]]))
    m = m._replace(pos=torch.where(m.valid[:, None], m.pos * scale, m.pos))

    return state._replace(
        kfs=kfs,
        map=m,
        num_kf=torch.tensor(2, dtype=I64, device=dev),
        last_kf_slot=torch.tensor(1, dtype=I64, device=dev),
        last_rvec=kfs.rvec[1],
        last_t=kfs.t[1],
        prev_rvec=kfs.rvec[1],  # zero initial velocity
        prev_t=kfs.t[1],
        last_feat=query_feat,
        last_matches=kfs.matches[1],
        frame_count=torch.tensor(query_index + 1, dtype=I64, device=dev),
        obs_desc=m.observation_descriptors(kfs)[0].to(torch.bfloat16),
        last_inliers=torch.sum(match_valid).to(I64),
    )


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


class Slam:
    """Host orchestrator: owns the device state, decodes and uploads frames,
    drives the steps. Same public surface as the JAX package's Slam, plus
    the `device` the state lives on."""

    def __init__(
        self,
        cam: Camera,
        video,  # iterable of [H, W] float32 in [0, 1] or uint8 frames
        config: SlamConfig = SlamConfig(),
        static_mask: np.ndarray | None = None,
        seed: int = 0,
        frontend=None,
        device: str | torch.device = "cpu",
    ):
        check_slice_config(config, frontend)
        self.cam = cam
        self.cfg = config
        self.device = torch.device(device)
        self.video = iter(video)
        self.frontend = frontend if frontend is not None else ClassicalFrontend(
            cell=config.cell, n_per_cell=config.n_per_cell,
            max_distance=config.max_match_distance,
        )
        self._mask = None if static_mask is None else torch.from_numpy(
            (np.asarray(static_mask) > 0).astype(np.float32)).to(self.device)
        self._seed = seed
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._frame_idx = 0
        self._prefetched = None
        self._pushback: list[np.ndarray] = []
        self.reset_state()
        self.infos: list = []
        self.batch_infos: list = []
        self._lost_streak = 0
        self._frames_since_check = 0
        self._pending_info: StepInfo | None = None
        self.segments: list[dict] = []
        self.n_reinits = 0
        self.eof_on_reinit = False
        self._arch_overflow_warned = False
        # Host reads (device->host synchronisations) made by the driver and
        # its steps: one per tracking frame, one per bootstrap attempt.
        self.host_syncs = {"track": 0, "bootstrap": 0}
        self.frames_tracked = 0

    # -- frame source -------------------------------------------------------
    def _to_u8(self, img) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        return img

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        """uint8 host frames -> device, through pinned memory on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _decode_next(self):
        if self._pushback:
            img = self._pushback.pop(0)
        else:
            try:
                img = self._to_u8(next(self.video))
            except StopIteration:
                return None
        self._frame_idx += 1
        return self._upload(img)

    def _next_frame(self):
        if self._prefetched is not None:
            img, self._prefetched = self._prefetched, None
            return img
        return self._decode_next()

    def _extract(self, img: torch.Tensor) -> Features:
        if img.dtype == torch.uint8:
            img = img.to(torch.float32) * (1.0 / 255.0)
        return self.frontend.extract(img, self._mask)

    def reset_state(self) -> None:
        """Fresh world state with this engine's shapes."""
        K = self.frontend.num_keypoints(self.cam.height, self.cam.width)
        self.state = SlamState.create(
            F=self.cfg.max_keyframes, P=self.cfg.map_capacity, O=self.cfg.max_observations,
            K=K, D=self.frontend.descriptor_dim, A=self.cfg.archive_capacity,
            device=self.device,
        )

    def reset_run(self, video) -> None:
        """Reset world state AND driver bookkeeping for a fresh run."""
        self.reset_state()
        self.video = iter(video)
        self._frame_idx = 0
        self._prefetched = None
        self._pushback = []
        self._gen.manual_seed(self._seed)
        self._lost_streak = 0
        self._frames_since_check = 0
        self._pending_info = None
        self.infos = []
        self.batch_infos = []
        self.segments = []
        self.n_reinits = 0
        self.eof_on_reinit = False
        self._arch_overflow_warned = False
        self.host_syncs = {"track": 0, "bootstrap": 0}
        self.frames_tracked = 0

    # -- public API ---------------------------------------------------------
    def initialize(self) -> bool:
        """Two-view bootstrap."""
        img = self._next_frame()
        if img is None:
            return False
        ref_img = img
        ref_feat = self._extract(img)
        ref_index = self._frame_idx - 1
        chances = 0
        while True:
            img = self._next_frame()
            if img is None:
                return False
            chances += 1
            if chances > self.cfg.max_ref_chances:
                ref_img, ref_feat, ref_index = img, self._extract(img), self._frame_idx - 1
                chances = 0
                continue
            query_feat = self._extract(img)
            att = try_initialize(ref_feat, query_feat, self._gen, cam=self.cam, cfg=self.cfg,
                                 matcher=self.frontend.matcher)
            self.host_syncs["bootstrap"] += 1
            if int(att.n_triangulated) < self.cfg.min_init_points:
                continue
            self.state = commit_initialization(
                self.state, ref_feat, query_feat, ref_img, att.pose, att.match_train,
                att.match_valid, ref_index, self._frame_idx - 1, cam=self.cam, cfg=self.cfg,
            )
            return True

    def _track(self, img: torch.Tensor) -> StepInfo:
        self.state, info = slam_step(self.state, img, self._mask, cam=self.cam, cfg=self.cfg,
                                     frontend=self.frontend)
        self.host_syncs["track"] += 1
        self.frames_tracked += 1
        return info

    def step(self) -> StepInfo | None:
        """Process one frame. Returns None at EOF."""
        while True:
            img = self._next_frame()
            if img is None:
                return None
            info = self._track(img)
            self._prefetched = self._decode_next()
            self.infos.append(info)
            if not self.cfg.reinit_on_lost:
                return info
            self._frames_since_check += 1
            if self._frames_since_check < self.cfg.lost_check_interval:
                return info
            self._frames_since_check = 0
            prev, self._pending_info = self._pending_info, info
            if prev is None or self._check_tracking(prev):
                return info

    def _check_tracking(self, info: StepInfo) -> bool:
        """Declare tracking lost after `lost_patience` low-inlier checks;
        archive the segment and re-bootstrap. False when a re-init ran."""
        if info.n_inliers >= self.cfg.min_track_matches:
            self._lost_streak = 0
            return True
        self._lost_streak += 1
        if self._lost_streak < self.cfg.lost_patience:
            return True
        self._lost_streak = 0
        self._pending_info = None
        self._recover_lost()
        return False

    def run(self, max_frames: int | None = None) -> list:
        n = 0
        while max_frames is None or n < max_frames:
            if self.step() is None:
                break
            n += 1
        return self.infos

    # -- batched stepping ----------------------------------------------------
    def _decode_batch(self, n: int) -> list[np.ndarray]:
        frames = []
        while self._pushback and len(frames) < n:
            frames.append(self._pushback.pop(0))
            self._frame_idx += 1
        while len(frames) < n:
            try:
                img = next(self.video)
            except StopIteration:
                break
            frames.append(self._to_u8(img))
            self._frame_idx += 1
        return frames

    def run_batched(self, max_frames: int | None = None, batch: int = 16) -> int:
        """Process the stream in batches of `batch` frames.

        A worker thread decodes, stacks and uploads batch i+1 (pinned memory,
        non-blocking) while the frames of batch i are tracked one by one.
        Loss detection runs once per batch on the PREVIOUS batch's inlier
        counts, with the JAX driver's semantics (and the same speculative
        check of the current batch when the previous one ends starved); on
        recovery, prefetched frames are pushed back to the stream. Returns
        the number of frames processed.
        """
        if self._prefetched is not None:
            raise RuntimeError("do not mix step() and run_batched()")
        self.batch_infos = []
        total = 0
        prev_infos: list | None = None

        def want(total_sim: int) -> int:
            return batch if max_frames is None else min(batch, max_frames - total_sim)

        def prep(n_want: int):
            frames = self._decode_batch(n_want)
            if not frames:
                return None
            return self._upload(np.stack(frames)), frames

        def push_back(fut):
            if fut is None:
                return
            res = fut.result()
            if res is not None:
                self._pushback = res[1] + self._pushback
                self._frame_idx -= len(res[1])

        ex = ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(prep, want(total))
        try:
            while max_frames is None or total < max_frames:
                res = fut.result()
                fut = None
                if res is None:
                    break
                imgs, raw = res
                n = len(raw)
                if max_frames is None or total + n < max_frames:
                    fut = ex.submit(prep, want(total + n))
                infos = [self._track(imgs[i]) for i in range(n)]
                self.batch_infos.append(infos)
                total += n
                if not self.cfg.reinit_on_lost:
                    continue
                lost = prev_infos is not None and self._batch_lost(prev_infos)
                speculated = False
                if not lost and prev_infos and (
                    prev_infos[-1].n_inliers < self.cfg.min_track_matches
                ):
                    lost = self._batch_lost(infos)
                    speculated = True
                if lost:
                    push_back(fut)
                    fut = None
                    self._recover_lost()
                    prev_infos = None
                    fut = ex.submit(prep, want(total))
                    continue
                prev_infos = None if speculated else infos
        finally:
            push_back(fut)
            ex.shutdown()
        return total

    def _batch_lost(self, infos: list) -> bool:
        """Detection over a completed batch: only the low-inlier streak still
        open at the batch end counts (updates the persistent streak)."""
        lost_run = self._lost_streak
        for info in infos:
            lost_run = lost_run + 1 if info.n_inliers < self.cfg.min_track_matches else 0
        if lost_run < self.cfg.lost_patience:
            self._lost_streak = lost_run
            return False
        self._lost_streak = 0
        return True

    def _recover_lost(self) -> None:
        """Archive the segment and re-bootstrap; if the stream ends before a
        bootstrap completes, restore the archived world state."""
        backup = self.state
        self.segments.append(dict(
            poses=self.poses(include_archived=True),
            frame_indices=self.keyframe_indices(include_archived=True),
            points=self.points(),
        ))
        self.reset_state()
        self.n_reinits += 1
        if not self.initialize():
            self.state = backup
            self.segments.pop()
            self.n_reinits -= 1
            self.eof_on_reinit = True
        self._prefetched = None

    # -- accessors -----------------------------------------------------------
    def _kf_slots(self) -> np.ndarray:
        v = self.state.kfs.valid.cpu().numpy()
        fi = self.state.kfs.frame_index.cpu().numpy()
        slots = np.nonzero(v)[0]
        return slots[np.argsort(fi[slots], kind="stable")]

    def archived(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Evicted-keyframe archive (frame_indices, rvec, t) in eviction order."""
        A = self.state.arch_frame_index.shape[0]
        total = int(self.state.arch_count)
        if total > A and not self._arch_overflow_warned:
            self._arch_overflow_warned = True
            import warnings

            warnings.warn(f"keyframe archive overflow: {total} evictions > capacity {A}; "
                          "raise SlamConfig.archive_capacity")
        n = min(total, A)
        return (self.state.arch_frame_index[:n].cpu().numpy(),
                self.state.arch_rvec[:n].cpu().numpy(),
                self.state.arch_t[:n].cpu().numpy())

    def poses(self, include_archived: bool = False) -> np.ndarray:
        """[N, 4, 4] keyframe poses in temporal order (archive first)."""
        s = torch.from_numpy(self._kf_slots()).to(self.device)
        T = se3.pose_matrix(self.state.kfs.rvec[s], self.state.kfs.t[s]).cpu().numpy()
        if not include_archived:
            return T
        _, arv, at = self.archived()
        if len(arv) == 0:
            return T
        Ta = se3.pose_matrix(torch.from_numpy(arv), torch.from_numpy(at)).numpy()
        return np.concatenate([Ta, T], axis=0)

    def keyframe_indices(self, include_archived: bool = False) -> np.ndarray:
        live = self.state.kfs.frame_index.cpu().numpy()[self._kf_slots()]
        if not include_archived:
            return live
        afi, _, _ = self.archived()
        return np.concatenate([afi, live], axis=0)

    def points(self) -> np.ndarray:
        m = self.state.map
        return m.pos.cpu().numpy()[m.valid.cpu().numpy()]

    def reprojection_error(self) -> float:
        return float(keyframe_reprojection_error(self.cam, self.state.map, self.state.kfs))
