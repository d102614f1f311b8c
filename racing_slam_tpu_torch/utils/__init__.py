"""Host-side utilities: synthetic sequences and JAX-state conversion."""
