"""The learned path: SuperPoint frontend and LightGlue matcher."""

from pathlib import Path

# The JAX package's committed weight files, read in place as .npz data.
WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "racing_slam_tpu" / "weights"
