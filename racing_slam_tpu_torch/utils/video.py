"""Host-side frame sources (port of racing_slam_tpu/utils/video.py).

Decoding stays on the host: `open_video` returns the native threaded
decoder (`native_bindings`, uint8 frames) when the committed library loads,
else `VideoLoader` (cv2, float32 frames in [0, 1]); the returned loader's
`decoder` attribute says which ("native" or "cv2"). `Slam` takes either.
cv2 is imported only when a file is opened. `ArraySource` iterates frames
held in memory.
"""

from __future__ import annotations

import numpy as np

from .. import native_bindings


def open_video(path: str, prefer_native: bool = True):
    """The native decoder when `prefer_native` and the library loads, else
    the cv2 one."""
    if prefer_native and native_bindings.available():
        loader = native_bindings.NativeVideoLoader(path)
        loader.decoder = "native"
        return loader
    return VideoLoader(path)


class VideoLoader:
    """Sequential mp4/avi decoder through cv2: grayscale float32 [H, W] in
    [0, 1] (or RGB [H, W, 3] with gray=False)."""

    decoder = "cv2"

    def __init__(self, path: str, gray: bool = True):
        import cv2

        self._cap = cv2.VideoCapture(str(path))
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        self._gray = gray

    def get_next_frame(self) -> np.ndarray | None:
        import cv2

        ok, frame = self._cap.read()
        if not ok:
            return None
        if self._gray:
            return cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255.0
        return frame[..., ::-1].astype(np.float32) / 255.0  # BGR -> RGB

    def get_all_frames(self) -> list:
        frames = []
        while (f := self.get_next_frame()) is not None:
            frames.append(f)
        return frames

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        f = self.get_next_frame()
        if f is None:
            raise StopIteration
        return f


def load_mask(path: str) -> np.ndarray:
    """Grayscale static mask as float32 [H, W]: 1 where feature detection is
    allowed (nonzero pixels), 0 elsewhere."""
    if native_bindings.available():
        return native_bindings.load_mask_native(path)
    import cv2

    m = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if m is None:
        raise FileNotFoundError(f"cannot open mask: {path}")
    return (m > 0).astype(np.float32)


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
