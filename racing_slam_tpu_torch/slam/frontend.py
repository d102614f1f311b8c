"""Feature frontends and frame matchers (port of racing_slam_tpu/slam/frontend.py).

``ClassicalFrontend.extract(img, mask) -> Features`` runs kernel K1 (the
image stack) for a CUDA frame and its plain twin for a CPU frame, then the
grid-corner selection and the patch descriptors in plain PyTorch. The
learned frontend, ``models.superpoint.SuperPointFrontend``, has the same
interface. A frontend's ``matcher`` slot holds the frame<->frame matcher:
``ClassicalMatcher`` (mutual 1-NN) or ``LightGlueMatcher`` (attention,
kernel K6), which Slam puts there for ``SlamConfig.matcher="lightglue"``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import lightglue
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


class LightGlueMatcher:
    """The LightGlue attention matcher behind the frame-matching interface;
    it uses the keypoint coordinates for its rotary position encoding.
    `params` come from `models.lightglue.load_params` (`weights`: the file
    they came from, if any) and must lie on `device`, the card unless the
    caller asks for the CPU. Takes one frame pair, or S pairs with a
    leading S (K6 once for all S at each attention site)."""

    def __init__(self, params: lightglue.LightGlueParams, image_size: tuple[float, float],
                 threshold: float = 0.35, device="cuda", weights: str | None = None):
        dev = resolve_device(device)
        if params.in_proj_w.device.type != dev.type:
            raise ValueError(f"LightGlue weights on {params.in_proj_w.device}, matcher on {dev}")
        self.params = params
        self.image_size = image_size
        self.threshold = threshold
        self.weights = weights

    def __call__(self, desc0, xy0, valid0, desc1, xy1, valid1):
        return lightglue.match(self.params, desc0, xy0, valid0, desc1, xy1, valid1,
                               self.image_size, self.threshold)


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
        """Features of one float32 [H, W] frame, or of S frames [S, H, W] with
        one K1 launch (Features with a leading S); `mask` [H, W], nonzero =
        allowed."""
        score, peaks, blurred = corner_frontend_fused(img, mask)
        c = select_corners_from_maps(score, peaks, cell=self.cell, n_per_cell=self.n_per_cell)
        d = extract_descriptors_cells(img, c.xy, self.cell, self.n_per_cell, blurred=blurred)
        return Features(xy=c.xy, desc=d, valid=c.valid, score=c.score)
