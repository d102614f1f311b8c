"""Geometry, image, matching and bundle-adjustment operations on tensors."""
