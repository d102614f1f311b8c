"""Classical feature frontend (port of racing_slam_tpu/slam/frontend.py).

``ClassicalFrontend.extract(img, mask) -> Features`` runs kernel K1 (the
image stack) for a CUDA frame and its plain twin for a CPU frame, then the
grid-corner selection and the patch descriptors in plain PyTorch.
``ClassicalMatcher`` is the mutual-1NN frame matcher.
"""

from __future__ import annotations

import torch

from ..ops.corners import select_corners_from_maps
from ..ops.descriptors import DESCRIPTOR_DIM, MAX_DISTANCE, extract_descriptors_cells
from ..ops.kernels.frontend import corner_frontend_fused
from ..ops.matching import match_frames
from .state import Features


class ClassicalMatcher:
    """Mutual-1NN descriptor matching with a distance gate."""

    def __init__(self, max_distance: float = MAX_DISTANCE):
        self.max_distance = max_distance

    def __call__(self, desc0, xy0, valid0, desc1, xy1, valid1):
        return match_frames(desc0, valid0, desc1, valid1, self.max_distance)


class ClassicalFrontend:
    """Shi-Tomasi grid corners + normalised patch descriptors."""

    def __init__(self, cell: int = 16, n_per_cell: int = 2, max_distance: float = MAX_DISTANCE):
        self.cell = cell
        self.n_per_cell = n_per_cell
        self.max_distance = max_distance
        self.descriptor_dim = DESCRIPTOR_DIM
        self.matcher = ClassicalMatcher(max_distance)

    def num_keypoints(self, height: int, width: int) -> int:
        return self.n_per_cell * (-(-height // self.cell)) * (-(-width // self.cell))

    def extract(self, img: torch.Tensor, mask: torch.Tensor | None = None) -> Features:
        """Features of one float32 [H, W] frame; `mask` [H, W], nonzero = allowed."""
        score, peaks, blurred = corner_frontend_fused(img, mask)
        c = select_corners_from_maps(score, peaks, cell=self.cell, n_per_cell=self.n_per_cell)
        d = extract_descriptors_cells(img, c.xy, self.cell, self.n_per_cell, blurred=blurred)
        return Features(xy=c.xy, desc=d, valid=c.valid, score=c.score)
