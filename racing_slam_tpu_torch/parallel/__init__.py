"""Multi-sequence tracking, landmark-sharded bundle adjustment and whole-map
refinement (port of racing_slam_tpu/parallel)."""
