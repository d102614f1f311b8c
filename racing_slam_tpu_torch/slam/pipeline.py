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
- the hybrid commit cadence (pipeline.py:274, `window_ba_every > 1`): a host
  branch on the commit number, which `Slam` counts from the is_kf it
  reads anyway (arch_count + num_kf on the device).
- the adaptive pose prediction (pipeline.py:457): a host branch on the
  previous frame's inlier count, which that frame's one host read (or the
  bootstrap attempt's) brought back; `Slam` keeps it and counts the frames
  that took the essential-matrix prediction.
- the banded matcher's dense fallback (matching.py:357): masked compute.
  K5 and K2 are both launched and a device flag lets exactly one work; the
  `Slam` sums the flags on the device (`Slam.banded_fallbacks()`).
- the window BA and refinement LM loops (lax.while_loop): a fixed number of
  iterations with a device-side stop flag.

The frame<->frame matcher at the commit's triangulation and in the
bootstrap is `frontend.matcher`: mutual 1-NN, or LightGlue (kernel K6 at
every attention site) with `SlamConfig.matcher="lightglue"`. The frontend
is the classical one (kernel K1) or `models.superpoint.SuperPointFrontend`.

The commit solves either the reference shape (`local_ba_window=1`, kernel
K4) or a window of the W newest keyframes (`window_ba`); `Slam` runs the
periodic whole-map refinement (`refine_every_frames`, `full_ba` over the
compacted live map). The pose prediction is constant position, constant
velocity, essential-matrix (`essential_matrix_estimation`: frame<->frame
match + RANSAC every frame, drawing from the `Slam`'s torch.Generator) or
adaptive (constant position while the previous frame's inliers reach
`adaptive_pred_inliers`, else the essential prediction rescaled to the
last inter-frame speed).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import lightglue
from ..ops import se3
from ..ops.ba import HUBER_DELTA, BAProblem, full_ba, motion_ba, structure_ba, window_ba
from ..ops.camera import Camera, project, project_with_depth
from ..ops.image import bilinear_sample
from ..ops.matching import gather_rows, match_map_to_frame, unmatched_mask
from ..ops.ransac import compose_with_previous, estimate_relative_pose
from ..ops.triangulation import triangulate_points
from ..parallel.refine import (
    apply_refinement,
    apply_refinement_compact,
    build_global_problem,
    build_global_problem_compact,
)
from .config import SlamConfig
from .frontend import ClassicalFrontend, LightGlueMatcher
from .state import (
    I64,
    Features,
    KeyframeStore,
    SlamState,
    add_associations,
    create_points,
    keyframe_reprojection_error,
    point_reprojection_errors,
    point_reprojection_errors_sel,
    remove_points,
    row_of,
    set_drop,
    stack_states,
    state_row,
    take,
    tree_map,
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
    band_fallbacks: torch.Tensor | None = None  # banded matcher: dense fallbacks (0-2)
    essential_prediction: bool = False  # the pose came from the essential-matrix prediction


PREDICTIONS = ("constant_position", "constant_velocity", "adaptive")


def check_slice_config(cfg: SlamConfig) -> None:
    """Raise ValueError for a configuration value the port does not take.

    The `*_backend` fields choose between XLA and Pallas in the JAX package.
    The port has no such choice: each kernel wrapper runs its CUDA kernel for
    CUDA tensors and its plain twin for CPU tensors, so only "auto" (and
    "banded" for the matcher, the scale path's search) is accepted."""
    for field in ("matching_backend", "ba_backend", "frontend_backend"):
        value = getattr(cfg, field)
        if value != "auto" and not (field == "matching_backend" and value == "banded"):
            raise ValueError(f"{field}={value!r}: the port chooses kernel or twin by "
                             "the tensors' device; only 'auto' is accepted")
    if cfg.pose_prediction not in PREDICTIONS:
        raise ValueError(f"unknown pose_prediction {cfg.pose_prediction!r}")


def _shapes(tree: tuple) -> list:
    """The shapes of a NamedTuple tree's tensors, in field order."""
    return [s for v in tree for s in (_shapes(v) if isinstance(v, tuple) else [v.shape])]


def _huber(cfg: SlamConfig, cam: Camera) -> float:
    return HUBER_DELTA / cam.fx if cfg.huber_mode == "pixel" else HUBER_DELTA


def _ba_problem(kfs, m, sel: torch.Tensor, sel_ok: torch.Tensor, slot) -> BAProblem:
    """The commit BA's problem over the selected points `sel` ([n] slots,
    `sel_ok` the real ones), every keyframe in it and `slot` free; C
    stacked problems for stacked states (sel [C, n], slot [C])."""
    stacked = sel.dim() == 2
    F = kfs.valid.shape[-1]
    obs_kf = take(m.obs_kf, sel, stacked=stacked)
    obs_kp = take(m.obs_kp, sel, stacked=stacked)
    return BAProblem(
        cam_rvec=kfs.rvec,
        cam_t=kfs.t,
        points=take(m.pos, sel, stacked=stacked),
        obs_cam=obs_kf,
        obs_uv=take(kfs.kp_xy, obs_kf, obs_kp, stacked=stacked),
        obs_valid=take(m.obs_valid, sel, stacked=stacked) & sel_ok[..., None],
        cam_free=torch.arange(F, device=sel.device) == slot[..., None],
        cam_in_problem=kfs.valid,
        point_free=sel_ok,
        point_in_problem=sel_ok,
    )


def _k4_step(kfs, m, slot, K: int, *, cam: Camera, cfg: SlamConfig):
    """The reference shape: only the new keyframe free, the points it sees
    free, compacted to <= Pc slots (kernel K4). For one state, or C stacked
    ones in one K4 launch. Returns (cam_rvec, cam_t, map positions)."""
    stacked = m.valid.dim() == 2
    P = m.valid.shape[-1]
    sel, sel_ok = m.ba_point_selection(slot[..., None, None],
                                       min(P, cfg.ba_commit_budget or -(-K // 128) * 128))
    res = structure_ba(cam, _ba_problem(kfs, m, sel, sel_ok, slot), slot,
                       max_iters=cfg.ba_iters, huber_delta=_huber(cfg, cam))
    pos = set_drop(m.pos, torch.where(sel_ok, sel, torch.full_like(sel, P)), res.points,
                   stacked=stacked)
    return res.cam_rvec, res.cam_t, pos


def _window_step(kfs, m, slot, *, cam: Camera, cfg: SlamConfig):
    """The W newest keyframes free (two always stay frozen as gauge
    anchors), over the points they observe (window_ba), for one state, or
    C stacked ones in one window_ba call. Returns (cam_rvec, cam_t, map
    positions)."""
    stacked = m.valid.dim() == 2
    P = m.valid.shape[-1]
    W = cfg.local_ba_window
    newest_first = torch.argsort(
        torch.where(kfs.valid, -kfs.frame_index, torch.full_like(kfs.frame_index, 1 << 30)),
        stable=True)[..., :W]
    n_free = torch.clamp(torch.sum(kfs.valid, dim=-1) - 2, 1, W)
    free_slots = torch.where(torch.arange(W, device=slot.device) < n_free[..., None],
                             newest_first, torch.full_like(newest_first, -1))
    sel, sel_ok = m.ba_point_selection_mask(m.observed_by_any(free_slots) & m.valid,
                                            min(P, cfg.window_ba_budget))
    res = window_ba(cam, _ba_problem(kfs, m, sel, sel_ok, slot), free_slots,
                    max_iters=cfg.ba_iters, huber_delta=_huber(cfg, cam))
    pos = set_drop(m.pos, torch.where(sel_ok, sel, torch.full_like(sel, P)), res.points,
                   stacked=stacked)
    return res.cam_rvec, res.cam_t, pos


def _commit_ba(kfs, m, slot, K: int, *, cam: Camera, cfg: SlamConfig, commit_no):
    """The commit BA: the window of the W newest keyframes (W > 1, on the
    hybrid cadence's window turns only) or the reference shape (K4).
    Stacked states (commit_no: a list, or None) take one window_ba call for
    the rows whose commit takes the window and one K4 launch for the
    others."""
    W = cfg.local_ba_window
    if W > 1 and cfg.window_ba_every > 1 and commit_no is None:
        raise ValueError("window_ba_every > 1 needs the commit number (commit_no)")

    def takes_window(no) -> bool:
        return W > 1 and (cfg.window_ba_every <= 1 or no % cfg.window_ba_every == 0)

    if m.valid.dim() == 1:
        if takes_window(commit_no):
            return _window_step(kfs, m, slot, cam=cam, cfg=cfg)
        return _k4_step(kfs, m, slot, K, cam=cam, cfg=cfg)
    C = m.valid.shape[0]
    window = [takes_window(None if commit_no is None else commit_no[i]) for i in range(C)]
    if all(window):
        return _window_step(kfs, m, slot, cam=cam, cfg=cfg)
    if not any(window):
        return _k4_step(kfs, m, slot, K, cam=cam, cfg=cfg)
    out = {}
    for step, take_window in ((_window_step, True), (partial(_k4_step, K=K), False)):
        rows = [i for i in range(C) if window[i] == take_window]

        def sub(x):  # the rows that take this solver, stacked
            return torch.stack([x[i] for i in rows])

        # Neither solve reads the descriptors.
        sub_kfs = KeyframeStore(*[None if f == "desc" else sub(x)
                                  for f, x in zip(kfs._fields, kfs)])
        res = step(sub_kfs, tree_map(sub, m), sub(slot), cam=cam, cfg=cfg)
        out.update({i: [x[j] for x in res] for j, i in enumerate(rows)})
    return tuple(torch.stack(z) for z in zip(*(out[i] for i in range(C))))


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
    commit_no: int | list | None = None,
) -> SlamState:
    """The keyframe path: eviction + archive, associations, triangulation,
    commit BA (one free camera, or the window of the W newest), cull and
    obs-descriptor refresh. `commit_no` is the number of keyframes written
    since the bootstrap, the bootstrap's two included (arch_count + num_kf
    on the device); only the hybrid cadence (`window_ba_every > 1`) needs
    it, and `Slam` counts it on the host.

    For C stacked states (a leading C on every leaf and on `img`, `feat`,
    `rvec`, `t`, `matches`; `commit_no` a list) each step runs once over
    the C rows, each row as it would alone: the frame match over the C
    pairs, one window_ba call and one K4 launch for the rows that take
    each (_commit_ba), the cull's reprojection errors over the C rows."""
    stacked = state.map.valid.dim() == 2
    lead = state.map.valid.shape[:-1]
    F = cfg.max_keyframes
    kfs, m = state.kfs, state.map
    dev = rvec.device
    last_slot = state.last_kf_slot

    # Fill free slots first; at capacity evict the OLDEST keyframe, archiving
    # its pose (the archive write is dropped when nothing is evicted).
    big = torch.full_like(kfs.frame_index, torch.iinfo(I64).max)
    oldest = torch.argmin(torch.where(kfs.valid, kfs.frame_index, big), dim=-1)
    slot = torch.where(state.num_kf < F, state.num_kf, oldest)
    A = state.arch_frame_index.shape[-1]
    evict = state.num_kf >= F
    aidx = torch.where(evict, state.arch_count, torch.full_like(state.arch_count, A))[..., None]
    arch_rvec = set_drop(state.arch_rvec, aidx, row_of(kfs.rvec, oldest, stacked)[..., None, :],
                         stacked=stacked)
    arch_t = set_drop(state.arch_t, aidx, row_of(kfs.t, oldest, stacked)[..., None, :],
                      stacked=stacked)
    arch_fi = set_drop(state.arch_frame_index, aidx,
                       row_of(kfs.frame_index, oldest, stacked)[..., None], stacked=stacked)
    arch_count = state.arch_count + evict.to(I64)

    # Scrub observations of the evicted slot; drop points left unobserved.
    evicted_obs = m.observed_by(slot[..., None, None]) & m.valid
    m = m._replace(obs_valid=m.obs_valid & (m.obs_kf != slot[..., None, None]))
    orphan = m.valid & ~torch.any(m.obs_valid, dim=-1)
    m, kfs = remove_points(m, kfs, orphan)

    match_ok = (matches >= 0) & feat.valid
    kfs = write_keyframe(kfs, slot, rvec, t, feat,
                         torch.where(match_ok, matches, torch.full_like(matches, -1)),
                         state.frame_count)
    m = add_associations(m, slot, matches, match_ok, kfs.frame_index, policy=cfg.obs_policy)

    K = feat.xy.shape[-2]
    new_slots = new_created = None
    if cfg.triangulate_points:
        last_xy = row_of(kfs.kp_xy, last_slot, stacked)
        fm = matcher(row_of(kfs.desc, last_slot, stacked), last_xy,
                     row_of(kfs.kp_valid, last_slot, stacked), feat.desc, feat.xy, feat.valid)
        un = unmatched_mask(fm, row_of(kfs.matches, last_slot, stacked) >= 0,
                            row_of(kfs.matches, slot, stacked) >= 0)
        uv1 = take(last_xy, fm.train_idx, stacked=stacked)
        pose1 = se3.pose_matrix(row_of(kfs.rvec, last_slot, stacked),
                                row_of(kfs.t, last_slot, stacked))
        tri = triangulate_points(cam, pose1, se3.pose_matrix(rvec, t), uv1, feat.xy, mask=un,
                                 max_reproj_px=cfg.triangulation_reproj_px)
        colors = bilinear_sample(img, feat.xy, stacked=stacked)
        m, kfs, new_slots, new_created = create_points(
            m, tri.points, tri.valid, last_slot, slot, fm.train_idx,
            torch.arange(K, device=dev).expand(*lead, K), colors, kfs,
        )

    P = m.valid.shape[-1]
    if cfg.bundle_adjust:
        cam_rvec, cam_t, pos = _commit_ba(kfs, m, slot, K, cam=cam, cfg=cfg, commit_no=commit_no)
        kfs = kfs._replace(rvec=cam_rvec, t=cam_t)
        m = m._replace(pos=pos)
        rvec = row_of(cam_rvec, slot, stacked)
        t = row_of(cam_t, slot, stacked)

    if cfg.cull_points:
        # Incremental-exact cull over the points whose error inputs changed
        # (observed by the W newest keyframes, which cover every pose and
        # point either commit solver moved, or losing an observation to the
        # eviction). Masked compute in place of the JAX lax.cond: the exact
        # full sweep runs too and is taken when candidates overflow.
        newest = torch.argsort(
            torch.where(kfs.valid, -kfs.frame_index, torch.full_like(kfs.frame_index, 1 << 30)),
            stable=True,
        )[..., :max(cfg.local_ba_window, 1)]
        cand = (evicted_obs | m.observed_by_any(newest)) & m.valid
        Cb = min(P, cfg.cull_budget)
        csel, csel_ok = m.ba_point_selection_mask(cand, Cb)
        err_c, has_c = point_reprojection_errors_sel(cam, m, kfs, csel, csel_ok)
        bad = csel_ok & has_c & (err_c > cfg.cull_reproj_px)
        rm_compact = set_drop(torch.zeros((*lead, P), dtype=torch.bool, device=dev),
                              torch.where(bad, csel, torch.full_like(csel, P)), True,
                              stacked=stacked)
        err_f, has_f = point_reprojection_errors(cam, m, kfs)
        rm_full = m.valid & has_f & (err_f > cfg.cull_reproj_px)
        remove = torch.where((torch.sum(cand, dim=-1) <= Cb)[..., None], rm_compact, rm_full)
        m, kfs = remove_points(m, kfs, remove)

    # Refresh the obs-descriptor cache rows whose observation table changed:
    # tracked associations and created points.
    touched = torch.where(match_ok, matches, torch.full_like(matches, P))
    if new_slots is not None:
        touched = torch.cat([touched, torch.where(new_created, new_slots,
                                                  torch.full_like(new_slots, P))], dim=-1)
    safe = torch.clamp(touched, max=P - 1)
    drows = take(kfs.desc, take(m.obs_kf, safe, stacked=stacked),
                 take(m.obs_kp, safe, stacked=stacked), stacked=stacked).to(torch.bfloat16)
    obs_desc = set_drop(state.obs_desc, touched, drows, stacked=stacked)

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


def _essential_prediction(state: SlamState, feat: Features, generator, uniforms, *,
                          cam: Camera, cfg: SlamConfig, matcher, rescale: bool):
    """Pose from the frame<->frame essential matrix composed onto the last
    pose. With `rescale` (the adaptive mode) the relative translation, unit
    norm from the decomposition, is scaled to the last inter-frame camera
    displacement (JAX pipeline.py:438-455). For one state, or for S stacked
    ones (a leading S on every leaf and on `feat`, [S, H, K] `uniforms`),
    a row of which predicts to the bit what it would alone
    (ops/essential.py)."""
    last = state.last_feat
    fm = matcher(last.desc, last.xy, last.valid, feat.desc, feat.xy, feat.valid)
    uv1 = gather_rows(last.xy, fm.train_idx)
    est = estimate_relative_pose(cam, uv1, feat.xy, fm.valid, generator,
                                 num_hypotheses=cfg.ransac_hypotheses,
                                 threshold_px=cfg.ransac_threshold_px, uniforms=uniforms)
    T_last = se3.pose_matrix(state.last_rvec, state.last_t)
    rel = est.pose
    if rescale:
        T_prev = se3.pose_matrix(state.prev_rvec, state.prev_t)
        speed = torch.linalg.norm(se3.camera_center(T_last) - se3.camera_center(T_prev), dim=-1)
        rel_t = rel[..., :3, 3]
        rel = rel.clone()
        rel[..., :3, 3] = rel_t / (torch.linalg.norm(rel_t, dim=-1, keepdim=True) + 1e-9) \
            * speed[..., None]
    return se3.rt_from_matrix(compose_with_previous(rel, T_last))


def _motion_prediction(state: SlamState, cfg: SlamConfig):
    """The constant-velocity prediction, T_pred = (T_last inv(T_prev)) T_last,
    or the last pose (constant position, and adaptive above its threshold);
    for one state or S stacked ones, a row of which predicts to the bit
    what it would alone (se3.compose sums in a fixed order)."""
    if cfg.pose_prediction == "constant_velocity":
        T_last = se3.pose_matrix(state.last_rvec, state.last_t)
        T_prev = se3.pose_matrix(state.prev_rvec, state.prev_t)
        return se3.rt_from_matrix(se3.compose(se3.compose(T_last, se3.inverse(T_prev)), T_last))
    if cfg.pose_prediction in ("constant_position", "adaptive"):
        return state.last_rvec, state.last_t
    raise ValueError(f"unknown pose_prediction {cfg.pose_prediction!r}")


class _Tracked(NamedTuple):
    state: SlamState  # last pose, features, matches and inliers replaced
    matches: torch.Tensor
    n_kf_matches: torch.Tensor
    n_total: torch.Tensor
    n_last: torch.Tensor
    is_kf: torch.Tensor
    band_fallbacks: torch.Tensor | None


def _track(state: SlamState, feat: Features, rvec: torch.Tensor, t: torch.Tensor, *,
           cam: Camera, cfg: SlamConfig, frontend) -> _Tracked:
    """The tracking core of slam_step and slam_step_multi, from the
    predicted pose: match the last keyframe's points and optimise the pose,
    match the rest of the map and optimise again, then the keyframe
    decision and the post-solve inliers (the loss signal). For one state,
    or for S stacked ones (a leading S on every leaf, on `feat` and on the
    prediction), where each of K2 and K3 launches once for all rows."""
    P = cfg.map_capacity
    m = state.map
    lead = feat.valid.shape[:-1]
    K = feat.valid.shape[-1]
    dev = feat.xy.device
    huber = _huber(cfg, cam)
    obs_dvalid = m.obs_valid & m.valid[..., None]
    no_kp_matched = torch.zeros((*lead, K), dtype=torch.bool, device=dev)
    no_pt_matched = torch.zeros((*lead, P), dtype=torch.bool, device=dev)
    match_kw = dict(max_distance=frontend.max_distance, radius_px=cfg.match_radius_px,
                    backend=cfg.matching_backend)

    # Match the last keyframe's points, then optimise the pose.
    observed = torch.any((m.obs_kf == state.last_kf_slot[..., None, None]) & m.obs_valid, dim=-1)
    mm1 = match_map_to_frame(
        cam, se3.pose_matrix(rvec, t), m.pos, observed & m.valid, state.obs_desc, obs_dvalid,
        feat.xy, feat.desc, feat.valid, no_kp_matched, no_pt_matched, **match_kw,
    )
    matches = torch.where(mm1.valid, mm1.point_idx, torch.full_like(mm1.point_idx, -1))
    n_kf_matches = torch.sum(matches >= 0, dim=-1)

    def optimise(rvec, t, matches):
        if not cfg.optimize_pose:
            return rvec, t
        res = motion_ba(cam, rvec, t, feat.xy, gather_rows(m.pos, matches), matches >= 0,
                        max_iters=cfg.motion_ba_iters, huber_delta=huber)
        return res.rvec, res.t

    rvec, t = optimise(rvec, t, matches)

    # Match the whole map (keypoints and points not matched yet), optimise.
    tgt = torch.where(feat.valid & (matches >= 0), matches, torch.full_like(matches, P))
    pt_matched = torch.zeros((*lead, P + 1), dtype=torch.bool, device=dev).scatter(
        -1, tgt, True)[..., :P]
    mm2 = match_map_to_frame(
        cam, se3.pose_matrix(rvec, t), m.pos, m.valid, state.obs_desc, obs_dvalid, feat.xy,
        feat.desc, feat.valid, matches >= 0, pt_matched, **match_kw,
    )
    matches = torch.where(mm2.valid & (matches < 0), mm2.point_idx, matches)
    rvec, t = optimise(rvec, t, matches)

    # Keyframe decision + post-solve inliers (the loss signal).
    n_total = torch.sum((matches >= 0) & feat.valid, dim=-1)
    last_slot = state.last_kf_slot[..., None]
    last_m = gather_rows(state.kfs.matches, last_slot)[..., 0, :]
    last_v = gather_rows(state.kfs.kp_valid, last_slot)[..., 0, :]
    n_last = torch.sum((last_m >= 0) & last_v, dim=-1)
    is_kf = n_total < cfg.keyframe_match_ratio * n_last
    uv_m, depth_m = project_with_depth(cam, se3.pose_matrix(rvec, t), gather_rows(m.pos, matches))
    reproj_m = torch.linalg.norm(uv_m - feat.xy, dim=-1)
    n_inliers = torch.sum((matches >= 0) & feat.valid & (depth_m > 0.0)
                          & (reproj_m < cfg.inlier_px), dim=-1)
    if cfg.min_commit_inliers:
        is_kf = is_kf | (n_inliers < cfg.min_commit_inliers)

    state = state._replace(
        last_rvec=rvec, last_t=t, prev_rvec=state.last_rvec, prev_t=state.last_t,
        last_feat=feat, last_matches=matches, last_inliers=n_inliers,
    )
    fell_back = None if mm1.fell_back is None \
        else mm1.fell_back.to(I64) + mm2.fell_back.to(I64)
    return _Tracked(state, matches, n_kf_matches, n_total, n_last, is_kf, fell_back)


def slam_step(
    state: SlamState,
    img: torch.Tensor,
    mask: torch.Tensor | None,
    *,
    cam: Camera,
    cfg: SlamConfig,
    frontend,
    commit_no: int | None = None,
    generator: torch.Generator | None = None,
    uniforms: torch.Tensor | None = None,
    last_inliers: int | None = None,
) -> tuple[SlamState, StepInfo]:
    """One tracking step. `img` is an [H, W] uint8 or float32 frame on the
    state's device. Makes exactly one host read (is_kf + inlier count).
    `commit_no`: see _commit_keyframe. The essential-matrix prediction draws
    its RANSAC uniforms from `generator`, or takes fixed [H, K] `uniforms`.
    `last_inliers` is `state.last_inliers` as a host int, on which the
    adaptive prediction branches; `Slam` passes the one it read with the
    previous frame, and when it is None the step reads it (a second read)."""
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) * (1.0 / 255.0)
    feat = frontend.extract(img, mask)

    essential = cfg.essential_matrix_estimation
    if not essential and cfg.pose_prediction == "adaptive":
        if last_inliers is None:
            last_inliers = int(state.last_inliers)
        essential = last_inliers < cfg.adaptive_pred_inliers
    if essential:
        rvec, t = _essential_prediction(state, feat, generator, uniforms, cam=cam, cfg=cfg,
                                        matcher=frontend.matcher,
                                        rescale=not cfg.essential_matrix_estimation)
    else:
        rvec, t = _motion_prediction(state, cfg)

    tr = _track(state, feat, rvec, t, cam=cam, cfg=cfg, frontend=frontend)
    state = tr.state
    # The frame's one host read.
    is_kf_h, n_inl_h = torch.stack([tr.is_kf.to(I64), state.last_inliers]).tolist()
    if is_kf_h:
        state = _commit_keyframe(state, img, feat, state.last_rvec, state.last_t, tr.matches,
                                 cam=cam, cfg=cfg, matcher=frontend.matcher, commit_no=commit_no)
    state = state._replace(frame_count=state.frame_count + 1)

    every = cfg.reproj_monitor_every
    if every == 1 or (every == 0 and is_kf_h):
        state = state._replace(reproj_px=keyframe_reprojection_error(cam, state.map, state.kfs))
    elif every > 1:
        due = (state.frame_count % every == 0) | tr.is_kf
        state = state._replace(reproj_px=torch.where(
            due, keyframe_reprojection_error(cam, state.map, state.kfs), state.reproj_px))

    info = StepInfo(
        rvec=state.last_rvec,
        t=state.last_t,
        n_matches_kf=tr.n_kf_matches,
        n_matches_total=tr.n_total,
        n_last_kf_matches=tr.n_last,
        is_keyframe=bool(is_kf_h),
        n_points=state.map.num_points(),
        n_keyframes=state.num_kf,
        reproj_error_px=state.reproj_px,
        n_inliers=int(n_inl_h),
        band_fallbacks=tr.band_fallbacks,
        essential_prediction=essential,
    )
    return state, info


# ---------------------------------------------------------------------------
# Lockstep step of S sequences
# ---------------------------------------------------------------------------


class MultiStepInfo(NamedTuple):
    """Per-frame diagnostics of S sequences stepped in lockstep. The device
    fields carry a leading S; `is_keyframe`, `n_inliers` and
    `essential_prediction` are host lists (the step's one read, and the
    host choice it was made from). Rows that were not active hold what the
    step computed on their blank frame and are to be ignored, but for
    `n_inliers` (the row's kept count) and `band_fallbacks` (0)."""

    rvec: torch.Tensor
    t: torch.Tensor
    n_matches_kf: torch.Tensor
    n_matches_total: torch.Tensor
    n_last_kf_matches: torch.Tensor
    is_keyframe: list
    n_points: torch.Tensor
    n_keyframes: torch.Tensor
    reproj_error_px: torch.Tensor
    n_inliers: list
    essential_prediction: list | None = None  # per row: the essential-matrix prediction ran
    band_fallbacks: torch.Tensor | None = None  # [S] banded matcher: dense fallbacks (0-2)


def _row_mask(S: int, rows: list, device) -> torch.Tensor:
    """[S] bool on the device, True at `rows`, filled there (no host copy)."""
    mask = torch.zeros((S,), dtype=torch.bool, device=device)
    for i in rows:
        mask[i:i + 1].fill_(True)  # mask[i] = True would copy a host scalar and wait
    return mask


def _row_index(rows: list, device) -> torch.Tensor:
    """[len(rows)] int64 on the device holding `rows`, filled there (no host
    copy)."""
    idx = torch.empty((len(rows),), dtype=I64, device=device)
    for j, i in enumerate(rows):
        idx[j:j + 1].fill_(i)
    return idx


class _Motion(NamedTuple):
    """The leaves of a state that the essential prediction reads."""

    last_feat: Features
    last_rvec: torch.Tensor
    last_t: torch.Tensor
    prev_rvec: torch.Tensor
    prev_t: torch.Tensor


def _multi_prediction(states: SlamState, feat: Features, rows: list, *, cam: Camera,
                      cfg: SlamConfig, frontend, generators, uniforms, last_inliers):
    """The [S] predicted poses of the lockstep step and each row's host
    choice: the motion prediction, or, for the rows that take it (every
    active row with essential_matrix_estimation; with adaptive, the active
    rows whose previous inliers fall below adaptive_pred_inliers), the
    essential prediction run over those rows stacked. A row draws its
    [H, K] uniforms from its own generator only then, as its own Slam
    does; `uniforms` [S, H, K] fixes them instead."""
    S = feat.valid.shape[0]
    rvec, t = _motion_prediction(states, cfg)
    if cfg.essential_matrix_estimation:
        chosen = [i in rows for i in range(S)]
    elif cfg.pose_prediction == "adaptive":
        if last_inliers is None:
            last_inliers = states.last_inliers.tolist()
        chosen = [i in rows and last_inliers[i] < cfg.adaptive_pred_inliers for i in range(S)]
    else:
        return rvec, t, [False] * S
    sub = [i for i in range(S) if chosen[i]]
    if not sub:
        return rvec, t, chosen
    K = feat.valid.shape[-1]
    dev = feat.xy.device
    if uniforms is None:
        if generators is None:
            raise ValueError("the essential prediction needs each row's generator or uniforms")
        uniforms = torch.stack([torch.rand((cfg.ransac_hypotheses, K), generator=generators[i],
                                           device=dev, dtype=torch.float32) for i in sub])
    elif len(sub) < S:
        uniforms = stack_states([uniforms[i] for i in sub], dev)
    motion = _Motion(states.last_feat, states.last_rvec, states.last_t, states.prev_rvec,
                     states.prev_t)
    if len(sub) < S:  # the rows that take it, stacked (no host index: no copy to the card)
        motion = stack_states([state_row(motion, i) for i in sub], dev)
        feat = stack_states([state_row(feat, i) for i in sub], dev)
    e_rvec, e_t = _essential_prediction(
        motion, feat, None, uniforms, cam=cam, cfg=cfg, matcher=frontend.matcher,
        rescale=not cfg.essential_matrix_estimation)
    if len(sub) == S:
        return e_rvec, e_t, chosen
    at = {i: j for j, i in enumerate(sub)}
    rvec, t = stack_states([state_row((e_rvec, e_t), at[i]) if i in at else state_row((rvec, t), i)
                            for i in range(S)], dev)
    return rvec, t, chosen


def slam_step_multi(
    states: SlamState,
    imgs: torch.Tensor,
    active: list,
    mask: torch.Tensor | None,
    *,
    cam: Camera,
    cfg: SlamConfig,
    frontend,
    commit_nos: list | None = None,
    generators: list | None = None,
    uniforms: torch.Tensor | None = None,
    last_inliers: list | None = None,
) -> tuple[SlamState, MultiStepInfo]:
    """One tracking step of S sequences in lockstep (the JAX package's
    `vmap` of its step, multi_seq.py:82-109): `states` stacked (leading S on
    every leaf, slam.state.stack_states), `imgs` [S, H, W] uint8 or float32
    on their device, `active` S host bools (False: the sequence has no frame
    now, its row is left as it was).

    The tracking is slam_step's own (_track over the stacked rows): the
    frontend extracts the S frames at once (the classical one with one K1
    launch; SuperPoint runs its network a frame at a time) and K2 and K3
    run twice, each one launch for all rows; the banded matcher
    (`matching_backend="banded"`) launches K5 and its K2 fallback once for
    all rows too, each row falling back alone. The pose prediction is
    slam_step's: the motion prediction, or the essential prediction over
    the rows that take it, its frame match `frontend.matcher` over those
    rows stacked (LightGlue: each attention site one K6 call for all of
    them), drawing row i's RANSAC uniforms from `generators[i]` (or taking
    them from `uniforms` [S, H, K]); `adaptive` chooses per row from
    `last_inliers`, each row's
    state.last_inliers as host ints (the previous lockstep frame's read;
    when None, the step reads them, a second read). The [S] keyframe
    decisions and inlier counts come back in the step's one host read,
    which names the active rows that commit. Those rows, gathered into one
    stacked sub-state, run one `_commit_keyframe` (kernel K4 once for all
    of them, or window_ba a row at a time where the commit takes the
    window; the frame match over their pairs, LightGlue's K6 once a site),
    and are written back into the stacked state in place. The JAX package
    runs the commit for every row under `select`; the results are the
    same, the commit work is not. `commit_nos` are the rows' commit numbers
    (see _commit_keyframe). Returns (states, MultiStepInfo); the input
    `states` is updated in place where rows commit."""
    S = imgs.shape[0]
    dev = imgs.device
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) * (1.0 / 255.0)
    feat = frontend.extract(imgs, mask)
    rows = [i for i in range(S) if active[i]]
    rvec, t, essential = _multi_prediction(
        states, feat, rows, cam=cam, cfg=cfg, frontend=frontend, generators=generators,
        uniforms=uniforms, last_inliers=last_inliers)
    tr = _track(states, feat, rvec, t, cam=cam, cfg=cfg, frontend=frontend)
    tracked = tr.state
    act = None
    fell_back = tr.band_fallbacks
    if len(rows) < S:  # inactive rows keep their state (JAX's `active` cond)
        act = _row_mask(S, rows, dev)
        tracked = type(states)(*[
            v if v is old else tree_map(
                lambda a, b: torch.where(act.reshape(S, *[1] * (a.dim() - 1)), a, b), v, old)
            for v, old in zip(tracked, states)])
        if fell_back is not None:
            fell_back = torch.where(act, fell_back, torch.zeros_like(fell_back))
    # The lockstep frame's one host read.
    is_kf_h, n_inl_h = torch.stack([tr.is_kf.to(I64), tracked.last_inliers]).tolist()
    states = tracked
    commits = [i for i in rows if is_kf_h[i]]
    if commits:
        # The committing rows as one stacked sub-state (all rows: the
        # state itself), one commit over them, written back in place.
        idx = None if len(commits) == S else _row_index(commits, dev)

        def pick(x):
            return x if idx is None else x.index_select(0, idx)

        sub = tree_map(pick, states)
        sub = _commit_keyframe(sub, pick(imgs), tree_map(pick, feat), sub.last_rvec, sub.last_t,
                               pick(tr.matches), cam=cam, cfg=cfg, matcher=frontend.matcher,
                               commit_no=None if commit_nos is None
                               else [commit_nos[i] for i in commits])
        if idx is None:
            states = sub
        else:
            tree_map(lambda x, v: x.index_copy_(0, idx, v), states, sub)
    states = states._replace(
        frame_count=states.frame_count + (1 if act is None else act.to(I64)))

    every = cfg.reproj_monitor_every
    due = rows if every == 1 else commits if every == 0 else []
    for i in due:
        row = state_row(states, i)
        row.reproj_px.copy_(keyframe_reprojection_error(cam, row.map, row.kfs))
    if every > 1:
        # Masked over the active rows: due every N frames and at commits.
        fresh = torch.stack([keyframe_reprojection_error(cam, r.map, r.kfs)
                             for r in (state_row(states, i) for i in range(S))])
        upd = ((states.frame_count % every == 0) | tr.is_kf) & _row_mask(S, rows, dev)
        states = states._replace(reproj_px=torch.where(upd, fresh, states.reproj_px))

    info = MultiStepInfo(
        rvec=states.last_rvec,
        t=states.last_t,
        n_matches_kf=tr.n_kf_matches,
        n_matches_total=tr.n_total,
        n_last_kf_matches=tr.n_last,
        is_keyframe=[bool(is_kf_h[i]) and bool(active[i]) for i in range(S)],
        n_points=torch.sum(states.map.valid, dim=-1),
        n_keyframes=states.num_kf,
        reproj_error_px=states.reproj_px,
        n_inliers=[int(x) for x in n_inl_h],
        essential_prediction=essential,
        band_fallbacks=fell_back,
    )
    return states, info


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
    the `device` the state lives on: the card unless the caller passes
    device="cpu" (without a card, the default raises)."""

    def __init__(
        self,
        cam: Camera,
        video,  # iterable of [H, W] float32 in [0, 1] or uint8 frames
        config: SlamConfig = SlamConfig(),
        static_mask: np.ndarray | None = None,
        seed: int = 0,
        frontend=None,
        device: str | torch.device = "cuda",
    ):
        check_slice_config(config)
        self.cam = cam
        self.cfg = config
        self.device = resolve_device(device)
        self.video = iter(video)
        self.frontend = frontend if frontend is not None else ClassicalFrontend(
            cell=config.cell, n_per_cell=config.n_per_cell,
            max_distance=config.max_match_distance,
        )
        fdev = getattr(self.frontend, "device", self.device)
        if fdev.type != self.device.type:
            raise ValueError(f"the frontend's weights are on {fdev}, the Slam on {self.device}")
        if config.matcher == "lightglue":
            self.frontend.matcher = self._lightglue_matcher()
        self._mask = None if static_mask is None else torch.from_numpy(
            (np.asarray(static_mask) > 0).astype(np.float32)).to(self.device)
        self._seed = seed
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._frame_idx = 0
        self._prefetched = None
        self._pushback: list[np.ndarray] = []
        self.reset_state()
        # Periodic whole-map refinement (refine_every_frames): frames since
        # the last one, and each run's final cost as a device tensor (read
        # only by callers).
        self._frames_since_refine = 0
        self.refine_costs: list[torch.Tensor] = []
        self._band_fallbacks = torch.zeros((), dtype=I64, device=self.device)
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
        # Frames whose pose came from the essential-matrix prediction.
        self.essential_predictions = 0
        # Per-frame image retention for overlays (run.py --overlay-every):
        # off by default, it adds a device->host frame copy a step.
        self.keep_last_image = False
        self.last_image: np.ndarray | None = None

    def _lightglue_matcher(self) -> LightGlueMatcher:
        """LightGlue on the weights for the frontend's descriptor space:
        `lightglue_weights`, or the committed file picked by the descriptor
        dimension (JAX Slam, pipeline.py:870-904). The frontend's matcher
        is kept when it is already that one (Slams sharing a frontend, as
        MultiSlam's do, load the weights once)."""
        dim = self.frontend.descriptor_dim
        wpath = self.cfg.lightglue_weights or str(lightglue.default_weights(dim))
        size = (float(self.cam.width), float(self.cam.height))
        have = self.frontend.matcher
        if isinstance(have, LightGlueMatcher) and (have.weights, have.image_size, have.threshold) \
                == (wpath, size, self.cfg.lightglue_threshold) \
                and have.params.in_proj_w.device.type == self.device.type:
            return have
        params = lightglue.load_params(wpath, device=self.device)
        in_dim = params.in_proj_w.shape[0]
        if in_dim != dim:
            raise ValueError(
                f"LightGlue weights at {wpath} take {in_dim}-d descriptors but the "
                f"{type(self.frontend).__name__} produces {dim}-d ones; pass matching "
                "weights via lightglue_weights"
            )
        return LightGlueMatcher(params, image_size=size, threshold=self.cfg.lightglue_threshold,
                                device=self.device, weights=wpath)

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
        # Keyframes written since the bootstrap (arch_count + num_kf), kept
        # on the host from the is_kf each step reads anyway.
        self._commit_no = 0
        # state.last_inliers on the host (the adaptive prediction's branch),
        # from the previous frame's read or the bootstrap attempt's.
        self._last_inliers = 0

    def resume(self, state: SlamState) -> None:
        """Continue from `state` (a checkpoint from utils.checkpoint), with
        the host copies of its commit number and inlier count (one read).
        Its shapes must be this engine's (capacities, keypoints, descriptor
        dimension)."""
        if _shapes(state) != _shapes(self.state):
            raise ValueError("the state's shapes differ from this engine's: resume with the "
                             "capacities it was saved with (max_keyframes, map_capacity, ...)")
        self.state = state
        self._commit_no, self._last_inliers = torch.stack(
            [state.arch_count + state.num_kf, state.last_inliers]).tolist()

    def reset_run(self, video) -> None:
        """Reset world state AND driver bookkeeping for a fresh run."""
        self.reset_state()
        self.video = iter(video)
        self._frame_idx = 0
        self._prefetched = None
        self._pushback = []
        self._gen.manual_seed(self._seed)
        self._frames_since_refine = 0
        self.refine_costs = []
        self._band_fallbacks = torch.zeros((), dtype=I64, device=self.device)
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
        self.essential_predictions = 0

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
            # The attempt's one host read; the match count seeds the
            # adaptive prediction's signal (commit_initialization).
            n_tri, n_matched = torch.stack(
                [att.n_triangulated, torch.sum(att.match_valid)]).tolist()
            self.host_syncs["bootstrap"] += 1
            if n_tri < self.cfg.min_init_points:
                continue
            self.state = commit_initialization(
                self.state, ref_feat, query_feat, ref_img, att.pose, att.match_train,
                att.match_valid, ref_index, self._frame_idx - 1, cam=self.cam, cfg=self.cfg,
            )
            self._commit_no = 2
            self._last_inliers = n_matched
            return True

    def _track(self, img: torch.Tensor) -> StepInfo:
        self.state, info = slam_step(self.state, img, self._mask, cam=self.cam, cfg=self.cfg,
                                     frontend=self.frontend, commit_no=self._commit_no,
                                     generator=self._gen, last_inliers=self._last_inliers)
        self._commit_no += info.is_keyframe
        self._last_inliers = info.n_inliers
        self.essential_predictions += info.essential_prediction
        if info.band_fallbacks is not None:
            self._band_fallbacks += info.band_fallbacks
        self.host_syncs["track"] += 1
        self.frames_tracked += 1
        return info

    def banded_fallbacks(self) -> int:
        """Calls of the banded matcher since the run began whose band did
        not fit, so that the dense kernel did the search (a host read)."""
        return int(self._band_fallbacks)

    def _refine(self) -> None:
        """Whole-map refinement: full BA over the live map compacted to
        `refine_budget` points (or all of it when 0), the two oldest
        keyframes as gauge anchors, then the full 3 px cull (the commit
        cull only re-checks the points a commit touched)."""
        cfg, cam = self.cfg, self.cam
        state = self.state
        if cfg.refine_budget:
            prob, sel, sel_ok = build_global_problem_compact(
                state, min(cfg.map_capacity, cfg.refine_budget))
        else:
            prob = build_global_problem(state)
        res = full_ba(cam, prob, max_iters=cfg.refine_iters, huber_delta=_huber(cfg, cam))
        if cfg.refine_budget:
            state = apply_refinement_compact(state, res, sel, sel_ok)
        else:
            state = apply_refinement(state, res)
        if cfg.cull_points:
            err, has_obs = point_reprojection_errors(cam, state.map, state.kfs)
            remove = state.map.valid & has_obs & (err > cfg.cull_reproj_px)
            m, kfs = remove_points(state.map, state.kfs, remove)
            state = state._replace(map=m, kfs=kfs)
        self.state = state
        self.refine_costs.append(res.cost)

    def _maybe_refine(self, n_frames: int) -> None:
        """Refine once `refine_every_frames` frames have accumulated."""
        if not self.cfg.refine_every_frames:
            return
        self._frames_since_refine += n_frames
        if self._frames_since_refine < self.cfg.refine_every_frames:
            return
        self._frames_since_refine = 0
        self._refine()

    def step(self) -> StepInfo | None:
        """Process one frame. Returns None at EOF."""
        while True:
            img = self._next_frame()
            if img is None:
                return None
            info = self._track(img)
            if self.keep_last_image:
                self.last_image = img.cpu().numpy()
            self._prefetched = self._decode_next()
            self.infos.append(info)
            self._maybe_refine(1)
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
        recovery, prefetched frames are pushed back to the stream. Batches
        never cross a refinement boundary: the refinement runs after exactly
        `refine_every_frames` frames, before that batch's loss check, and
        once more at the end if frames accumulated since the last one.
        Returns the number of frames processed.
        """
        if self._prefetched is not None:
            raise RuntimeError("do not mix step() and run_batched()")
        self.batch_infos = []
        total = 0
        prev_infos: list | None = None

        every = self.cfg.refine_every_frames

        def want(total_sim: int, since_sim: int) -> int:
            n = batch if max_frames is None else min(batch, max_frames - total_sim)
            return min(n, max(1, every - since_sim)) if every else n

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
        fut = ex.submit(prep, want(total, self._frames_since_refine))
        try:
            while max_frames is None or total < max_frames:
                res = fut.result()
                fut = None
                if res is None:
                    break
                imgs, raw = res
                n = len(raw)
                # The next batch's size follows from the refine cadence
                # and the frame budget; prepare it while this one runs.
                since_sim = self._frames_since_refine + n
                if every and since_sim >= every:
                    since_sim = 0
                if max_frames is None or total + n < max_frames:
                    fut = ex.submit(prep, want(total + n, since_sim))
                infos = [self._track(imgs[i]) for i in range(n)]
                self.batch_infos.append(infos)
                total += n
                self._maybe_refine(n)
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
                    fut = ex.submit(prep, want(total, self._frames_since_refine))
                    continue
                prev_infos = None if speculated else infos
        finally:
            push_back(fut)
            ex.shutdown()
        # Callers read the state right after the run: refine what
        # accumulated since the last refinement.
        if every and self._frames_since_refine > 0:
            self._frames_since_refine = 0
            self._refine()
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
        backup = self.state, self._commit_no, self._last_inliers
        self.segments.append(dict(
            poses=self.poses(include_archived=True),
            frame_indices=self.keyframe_indices(include_archived=True),
            points=self.points(),
        ))
        self.reset_state()
        self.n_reinits += 1
        if not self.initialize():
            self.state, self._commit_no, self._last_inliers = backup
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

    def overlay_data(self) -> dict:
        """The last frame's overlay ingredients for utils.viz.save_overlay:
        keypoints (NaN where invalid), the matched map points projected at
        the frame's pose, and which keypoints matched (host copies)."""
        st = self.state
        valid = st.last_feat.valid.cpu().numpy()
        matches = st.last_matches
        pos = st.map.pos[torch.clamp(matches, min=0)]
        proj = project(self.cam, se3.pose_matrix(st.last_rvec, st.last_t), pos)
        return dict(
            image=None if self.last_image is None
            else self.last_image.astype(np.float32) / 255.0,
            keypoints=np.where(valid[:, None], st.last_feat.xy.cpu().numpy(), np.nan),
            projections=proj.cpu().numpy(),
            matches_mask=valid & (matches.cpu().numpy() >= 0),
        )
