"""Build, load and call the CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` file is compiled for sm_90a by its own nvcc process, all
started together, and the objects are linked into
``build/kernels/libslamkernels.so`` at the repository root, on first use;
the library is rebuilt only when a hash of the sources changes. The library exposes a plain
C interface: each entry point takes device pointers, sizes and the CUDA
stream, launches its kernel and returns ``cudaGetLastError()``; the wrappers
raise when that is not 0. No PyTorch header is compiled, which keeps the
build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libslamkernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point (all return int = cudaError_t).
SIGNATURES = {
    # img, mask|NULL, resp, peaks, blur2, B, H, W, taps1, r1, taps2, r2, border, stream
    "slam_frontend": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _P],
    # uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, skip|NULL, best_k,
    # best_d, S, P, O, D, K, radius_sq, stream
    "slam_guided_match": [_P] * 10 + [_I, _I, _I, _I, _I, _F, _P],
    # uv_p, gate_p, obs_desc, obs_valid, p_sel, kp_uv, kp_desc, kp_ok, starts, n_act,
    # best_k, best_d, S, P, G, O, D, K, tile_p, tile_k, band, radius_sq, stream
    "slam_guided_match_banded": [_P] * 12 + [_I] * 9 + [_F, _P],
    # pose0, kp_uv, xyz, valid, out, S, K, fx, cx, cy, lam0, huber, ftol, iters, stream
    "slam_motion_ba": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _I, _P],
    # cam_rvec, cam_t, free_slot, points, obs_cam, obs_uv, include, point_free,
    # out, points_out, scratch|NULL, S, F, P, O, fx, cx, cy, lam0, huber, ftol, iters,
    # cluster, stream
    "slam_structure_ba": [_P] * 11 + [_I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P],
    # q, k, v, mask_k, out, workspace, S, Kq, Kk, H, dh, chunks, fold, scale, stream
    "slam_flash_mha_seq": [_P] * 6 + [_I] * 7 + [_F, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into BUILD_DIR/LIB_NAME unless the hash matches."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    nvcc = find_nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [(p.args[-1], p.communicate()[0], p.returncode) for p in procs]
    failed = [f"{src}: nvcc failed ({rc}):\n{out}" for src, out, rc in logs if rc != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print("".join(out for _, out, _ in logs))
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.slam_structure_ba_scratch_bytes.argtypes = [_I, _I, _I]
            handle.slam_structure_ba_scratch_bytes.restype = ctypes.c_size_t
            handle.slam_structure_ba_max_clusters.argtypes = [_I, _I, _I]
            handle.slam_structure_ba_max_clusters.restype = ctypes.c_int
            handle.slam_motion_ba_max_clusters.argtypes = [_I]
            handle.slam_motion_ba_max_clusters.restype = ctypes.c_int
            handle.slam_flash_mha_seq_workspace_bytes.argtypes = [_I] * 6
            handle.slam_flash_mha_seq_workspace_bytes.restype = ctypes.c_size_t
            handle.slam_error_string.argtypes = [ctypes.c_int]
            handle.slam_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib().slam_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def device_kind(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a set of tensors on one device; raises otherwise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) != 1:
        raise ValueError(f"tensors on several device types: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device type {kind!r}")
    return kind


def stream(device: torch.device) -> int:
    """Handle of PyTorch's current CUDA stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Check dtype, shape (None = any) and contiguity of a kernel operand."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(t.shape) != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
