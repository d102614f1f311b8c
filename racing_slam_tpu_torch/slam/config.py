"""Engine configuration (port of racing_slam_tpu/slam/config.py: SlamConfig).

The same fields with the same defaults as the JAX package's SlamConfig, so
one set of values drives both packages (tests/test_torch_state.py checks
that the two dataclasses agree field by field). The meaning of each field,
and the measurements behind its default, are documented there. It is a
copy, not an import, because chip_smoke.py drives the port with no module
of the JAX package loaded (tests/test_torch_hygiene.py holds the port to
that). slam.pipeline.check_slice_config refuses the values of later slices
and any `*_backend` value but "auto".
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Engine flags, capacities and thresholds."""

    # The reference's five feature flags.
    triangulate_points: bool = False
    bundle_adjust: bool = True
    optimize_pose: bool = True
    cull_points: bool = False
    essential_matrix_estimation: bool = False

    # Capacities: F keyframes, P map points, O observations per point, A
    # archived keyframe poses; K = n_per_cell * ceil(H/cell) * ceil(W/cell).
    max_keyframes: int = 32
    map_capacity: int = 4096
    max_observations: int = 8
    archive_capacity: int = 512
    cell: int = 16
    n_per_cell: int = 2
    max_match_distance: float = 0.8

    # Keyframe decision, gates and budgets.
    keyframe_match_ratio: float = 0.9
    min_commit_inliers: int = 0
    cull_reproj_px: float = 3.0
    triangulation_reproj_px: float = 2.0
    cull_budget: int = 2048
    min_init_points: int = 50
    max_ref_chances: int = 5
    ba_iters: int = 10
    motion_ba_iters: int = 10
    ba_commit_budget: int = 0
    local_ba_window: int = 1
    window_ba_every: int = 1
    window_ba_budget: int = 1024
    huber_mode: str = "pixel"
    obs_policy: str = "replace_oldest"

    # Two-view geometry.
    ransac_hypotheses: int = 512
    init_ransac_hypotheses: int = 2048
    ransac_threshold_px: float = 0.4

    # Matcher, backends and pose prediction.
    matcher: str = "classical"
    lightglue_weights: str = ""
    lightglue_threshold: float = 0.35
    matching_backend: str = "auto"
    ba_backend: str = "auto"
    frontend_backend: str = "auto"
    pose_prediction: str = "constant_position"
    adaptive_pred_inliers: int = 40
    match_radius_px: float = 20.0

    # Loss detection and recovery.
    min_track_matches: int = 30
    inlier_px: float = 3.0
    lost_patience: int = 2
    reinit_on_lost: bool = True
    lost_check_interval: int = 4

    # Periodic refinement (not in this slice) and the reprojection monitor.
    refine_every_frames: int = 0
    refine_iters: int = 10
    refine_budget: int = 2048
    reproj_monitor_every: int = 1
