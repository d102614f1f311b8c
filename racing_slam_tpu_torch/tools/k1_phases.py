"""Where a tile of kernel K1 spends its cycles, on one CUDA card.

Run from the repository root:

    python3 -m racing_slam_tpu_torch.tools.k1_phases [--csrc DIR] [--batch 1,8]

Builds a copy of ``frontend_kernel.cu`` from DIR (by default the port's
``csrc/``; under ``build/k1_phases``) with clock64() probes in thread 0 of
one CTA (the middle tile of the last frame) at the start of the kernel
and before each of its passes: the load of the image region, the
horizontal blurs, the vertical blurs, Sobel and the products, the 3-sums
and the min eigenvalue, NMS along rows, NMS down columns (each a pass of
the CTA: thread 0 reaches the next probe when the barrier after the pass
lets it; a barrier is added after the last pass). Then runs the multi
path's frames (frame 1 of the bench worlds of ``chip_smoke.MULTI_SEEDS``)
at each B of ``--batch`` (B = 1: the single launch, with the bench's
mask; B > 1: the batched launch, unmasked) and prints for each: ms a
launch (``chip_smoke.cuda_ms``) and the probed CTA's cycles by pass,
averaged over ``--launches`` launches. The probes do not change the
kernel's arithmetic.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import kernel_ab

REPO = Path(__file__).resolve().parents[2]
PASSES = ("load", "h_blur", "v_blur", "sobel", "eigen", "nms_rows", "nms_cols")
HEADS = ("  // 2. Horizontal passes", "  // 3. Vertical passes", "  // 4. Sobel",
         "  // 5. Horizontal 3-sums", "  // 6. NMS along rows", "  // 7. NMS down columns")

# (text of the kernel, text it becomes): the probes.
PATCHES = [
    ("namespace {\n", "__device__ unsigned long long g_k1[8];\nnamespace {\n"),
    ("  const float* im = img + plane;\n",
     "  const float* im = img + plane;\n"
     "  const bool probe = blockIdx.x == gridDim.x / 2 && blockIdx.y == gridDim.y / 2 &&\n"
     "                     blockIdx.z == gridDim.z - 1 && tid == 0;\n"
     "  long long ph[8];\n  ph[0] = clock64();\n"),
    *[(head, f"  ph[{k + 1}] = clock64();\n{head}") for k, head in enumerate(HEADS)],
    ("          peaks_out[plane + (size_t)gy * W + gx] = v >= m[j] ? v : 0.0f;\n"
     "        }\n      }\n    }\n  }\n}\n",
     "          peaks_out[plane + (size_t)gy * W + gx] = v >= m[j] ? v : 0.0f;\n"
     "        }\n      }\n    }\n  }\n  __syncthreads();\n  if (probe) {\n"
     "    const long long end = clock64();\n"
     "    for (int k = 0; k < 6; ++k)\n"
     "      atomicAdd(&g_k1[k], (unsigned long long)(ph[k + 1] - ph[k]));\n"
     "    atomicAdd(&g_k1[6], (unsigned long long)(end - ph[6]));\n"
     "    atomicAdd(&g_k1[7], 1ull);\n  }\n}\n"),
]
READER = """
SLAM_API int slam_k1_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_k1, sizeof(g_k1));
  unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_k1, zero, sizeof(zero));
}
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=str(REPO / "racing_slam_tpu_torch" / "csrc"))
    ap.add_argument("--batch", default="1,8", help="frames a launch, at most 8")
    ap.add_argument("--launches", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    from ..ops.camera import Camera
    from .scaling import render_worlds

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    batches = [int(x) for x in args.batch.split(",")]
    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
    pool, pending = render_worlds(cam, [(s, cs.MULTI_FRAMES) for s in
                                        cs.MULTI_SEEDS[:max(batches)]])
    tree = kernel_ab.patched_tree("k1_phases", Path(args.csrc).resolve(), "frontend_kernel.cu",
                                  PATCHES, READER)
    so, log = kernel_ab.build("k1_phases", tree, ("k1",))
    for row in kernel_ab.ptxas_usage(log):
        print(f"k1_phases {row}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.slam_k1_phases.argtypes = [ctypes.c_void_p]
    call = kernel_ab.k1_caller(lib)
    dev = torch.device("cuda", 0)
    frames = np.stack([w[0][1] for w in pending.get()]).astype(np.float32) / 255.0
    pool.close()
    pool.join()
    mask = torch.from_numpy(cs._frontend_mask(480, 640)).to(dev)
    for B in batches:
        img = torch.from_numpy(frames[:B]).to(dev)
        msk = mask if B == 1 else None
        ms = cs.cuda_ms(lambda: call(img, msk))
        counts = (ctypes.c_ulonglong * 8)()
        lib.slam_k1_phases(counts)  # reset
        for _ in range(args.launches):
            call(img, msk)
        torch.cuda.synchronize()
        lib.slam_k1_phases(counts)
        n = max(counts[7], 1)
        cycles = ", ".join(f"{name} {counts[k] / n:.0f}" for k, name in enumerate(PASSES))
        total = sum(counts[k] for k in range(7)) / n
        print(f"B={B}: {ms:.4f} ms a launch; the probed CTA's cycles ({counts[7]} launches): "
              f"{cycles}; total {total:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
