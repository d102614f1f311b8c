"""Global map refinement on the live engine state (port of
racing_slam_tpu/parallel/refine.py, single device).

A periodic FULL bundle adjustment over the live SlamState: every keyframe
pose except the two gauge anchors and every map point free. A monocular
map has a similarity gauge; freezing the two OLDEST valid keyframes pins
pose and scale as the bootstrap does (reference frame fixed, unit
baseline). `make_refine_step` runs it over every row of a stacked
multi-sequence state, each row's landmarks split over the mesh's 'lm'
ranks (parallel/dist_ba.py).
"""

from __future__ import annotations

import torch

from ..ops import se3
from ..ops.ba import HUBER_DELTA, BAProblem, BAResult
from ..ops.camera import Camera
from ..slam.state import SlamState, row_of, set_drop, take


def gauge_anchor_mask(kfs_valid: torch.Tensor, frame_index: torch.Tensor) -> torch.Tensor:
    """[F] bool: True for the two oldest valid keyframes (frozen anchors);
    [S, F] for stacked states."""
    F = kfs_valid.shape[-1]
    big = torch.iinfo(frame_index.dtype).max
    order = torch.where(kfs_valid, frame_index, torch.full_like(frame_index, big))
    oldest = torch.argmin(order, dim=-1, keepdim=True)
    idx = torch.arange(F, device=order.device)
    second = torch.argmin(torch.where(idx == oldest, torch.full_like(order, big), order),
                          dim=-1, keepdim=True)
    return ((idx == oldest) | (idx == second)) & kfs_valid


def build_global_problem(state: SlamState) -> BAProblem:
    """BAProblem over the FULL live map: all valid keyframes but the two
    gauge anchors free, all valid points free. Stacked states give stacked
    problems."""
    kfs, m = state.kfs, state.map
    anchors = gauge_anchor_mask(kfs.valid, kfs.frame_index)
    return BAProblem(
        cam_rvec=kfs.rvec,
        cam_t=kfs.t,
        points=m.pos,
        obs_cam=m.obs_kf,
        obs_uv=take(kfs.kp_xy, m.obs_kf, m.obs_kp, stacked=m.valid.dim() == 2),
        obs_valid=m.obs_valid & m.valid[..., None],
        cam_free=kfs.valid & ~anchors,
        cam_in_problem=kfs.valid,
        point_free=m.valid,
        point_in_problem=m.valid,
    )


def build_global_problem_compact(
    state: SlamState, budget: int
) -> tuple[BAProblem, torch.Tensor, torch.Tensor]:
    """build_global_problem compacted to <= budget live points (most
    observed first, MapState.ba_point_selection_mask). Points over the
    budget keep their positions and face the post-refine cull.
    Returns (problem, sel [budget] map slots, sel_ok [budget])."""
    kfs, m = state.kfs, state.map
    anchors = gauge_anchor_mask(kfs.valid, kfs.frame_index)
    sel, sel_ok = m.ba_point_selection_mask(m.valid, budget)
    obs_kf = m.obs_kf[sel]
    obs_kp = m.obs_kp[sel]
    prob = BAProblem(
        cam_rvec=kfs.rvec,
        cam_t=kfs.t,
        points=m.pos[sel],
        obs_cam=obs_kf,
        obs_uv=kfs.kp_xy[obs_kf, obs_kp],
        obs_valid=m.obs_valid[sel] & sel_ok[:, None],
        cam_free=kfs.valid & ~anchors,
        cam_in_problem=kfs.valid,
        point_free=sel_ok,
        point_in_problem=sel_ok,
    )
    return prob, sel, sel_ok


def apply_refinement(state: SlamState, res: BAResult) -> SlamState:
    """Write refined poses and points into the state (stacked states and
    results: every row at once). The in-flight
    tracking poses (last and previous frame) move with the last keyframe's
    correction, T_new = T @ inv(T_kf_old) @ T_kf_new, so the constant
    velocity predictor sees an unchanged relative motion."""
    stacked = state.map.valid.dim() == 2
    slot = state.last_kf_slot
    T_old = se3.pose_matrix(row_of(state.kfs.rvec, slot, stacked),
                            row_of(state.kfs.t, slot, stacked))
    T_new = se3.pose_matrix(row_of(res.cam_rvec, slot, stacked), row_of(res.cam_t, slot, stacked))
    corr = se3.compose(se3.inverse(T_old), T_new)
    last_rvec, last_t = se3.rt_from_matrix(
        se3.compose(se3.pose_matrix(state.last_rvec, state.last_t), corr))
    prev_rvec, prev_t = se3.rt_from_matrix(
        se3.compose(se3.pose_matrix(state.prev_rvec, state.prev_t), corr))
    return state._replace(
        kfs=state.kfs._replace(rvec=res.cam_rvec, t=res.cam_t),
        map=state.map._replace(pos=res.points),
        last_rvec=last_rvec,
        last_t=last_t,
        prev_rvec=prev_rvec,
        prev_t=prev_t,
    )


def apply_refinement_compact(state: SlamState, res: BAResult, sel: torch.Tensor,
                             sel_ok: torch.Tensor) -> SlamState:
    """apply_refinement for the compacted problem: the refined points go
    back to their map slots (poses are full size)."""
    P = state.map.pos.shape[0]
    pos = set_drop(state.map.pos, torch.where(sel_ok, sel, torch.full_like(sel, P)), res.points)
    return apply_refinement(state, res._replace(points=pos))


def make_refine_step(
    cam: Camera,
    mesh=None,
    max_iters: int = 10,
    huber_delta: float = HUBER_DELTA,
):
    """The stacked-state refinement: fn(states [S, ...]) -> (states, cost
    [S]): build_global_problem over the stacked states, one landmark-sharded
    full BA of the S problems over `mesh`'s 'lm' axis
    (batched_distributed_full_ba; single device with no mesh), and
    apply_refinement over the stack, as the JAX package vmaps them. The rows
    are this rank's. As in the JAX package, no cull follows (the
    single-sequence Slam culls after its refinement)."""
    from .dist_ba import batched_distributed_full_ba

    def refine(states: SlamState) -> tuple[SlamState, torch.Tensor]:
        res = batched_distributed_full_ba(cam, build_global_problem(states), mesh,
                                          max_iters=max_iters, huber_delta=huber_delta)
        return apply_refinement(states, res), res.cost

    return refine
