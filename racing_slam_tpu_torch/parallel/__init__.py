"""Whole-map refinement on the live state (the mesh-sharded step comes with
the distributed slice)."""
