"""Host-side frame sources (port of racing_slam_tpu/utils/video.py:
ArraySource; the file decoders come with the CLI slice)."""

from __future__ import annotations

import numpy as np


class ArraySource:
    """Iterate over in-memory frames (synthetic sequences, tests)."""

    def __init__(self, frames):
        self._frames = list(frames)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= len(self._frames):
            raise StopIteration
        f = self._frames[self._i]
        self._i += 1
        return f
