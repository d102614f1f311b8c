"""Where a tile of kernel K6's main loop spends its cycles, on one CUDA card.

Run from the repository root:

    python3 -m racing_slam_tpu_torch.tools.k6_phases [--pads 0,30000,80000,150000]

Builds a copy of ``csrc/attention_kernel.cu`` (under ``build/k6_phases``)
with clock64() probes around the four phases of a key tile in the
CTA's warpgroup (waiting for the tile's copies, S = Q K^T, the
softmax, O += P V), summed over the tiles of one CTA (the first) by its
thread 0, and an extra amount of dynamic shared memory a CTA asks for
(``--pads`` bytes), which caps how many CTAs an SM holds. Then runs the
main path's [2400, 4, 32] at S = 1 (one chunk a CTA) and S = 8 (one chunk
a CTA, and every chunk of a tile in one CTA that folds), and prints for each: ms a call
(``chip_smoke.cuda_ms``), cycles a tile of each phase, and each kernel's
device time under torch.profiler. The probes do not change the kernel's
arithmetic. Compare phases between pads, not with the probe-free kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import kernel_ab

REPO = Path(__file__).resolve().parents[2]
CSRC = REPO / "racing_slam_tpu_torch" / "csrc"
PHASES = ("wait", "qk", "softmax", "pv")

# (text of the kernel, text it becomes): the probes and the padding.
PATCHES = [
    ("#include <algorithm>\n", "#include <algorithm>\n#include <cstdlib>\n"
     "__device__ unsigned long long g_phase[5];\n"),
    ("      const int i = t - t0, s = i % STAGES;\n      mbar_wait(full + 8 * s, (i / STAGES) & 1);\n",
     "      const int i = t - t0, s = i % STAGES;\n      long long p0 = clock64();\n"
     "      mbar_wait(full + 8 * s, (i / STAGES) & 1);\n      long long p1 = clock64();\n"),
    ("      wgmma_wait();\n      fence_regs(sc);\n",
     "      wgmma_wait();\n      fence_regs(sc);\n      long long p2 = clock64();\n"),
    ("      fence_regs(o);\n      wgmma_fence();\n",
     "      fence_regs(o);\n      long long p3 = clock64();\n      wgmma_fence();\n"),
    ("      if (lane == 0) mbar_arrive(empty + 8 * s);\n",
     "      if (lane == 0) mbar_arrive(empty + 8 * s);\n"
     "      if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) {\n"
     "        long long p4 = clock64();\n"
     "        atomicAdd(&g_phase[0], (unsigned long long)(p1 - p0));\n"
     "        atomicAdd(&g_phase[1], (unsigned long long)(p2 - p1));\n"
     "        atomicAdd(&g_phase[2], (unsigned long long)(p3 - p2));\n"
     "        atomicAdd(&g_phase[3], (unsigned long long)(p4 - p3));\n"
     "        atomicAdd(&g_phase[4], 1ull);\n      }\n"),
    ("  constexpr uint32_t smem = main_smem_bytes<DH>();\n  static const cudaError_t attr",
     "  const uint32_t smem = main_smem_bytes<DH>() + atoi(getenv(\"K6_PAD\"));\n"
     "  const cudaError_t attr"),
]
READER = """
SLAM_API int slam_k6_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pads", default="0,30000,80000,150000", help="extra smem bytes a CTA")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    so, _ = kernel_ab.build("k6_phases", kernel_ab.patched_tree(
        "k6_phases", CSRC, "attention_kernel.cu", PATCHES, READER))
    lib = ctypes.CDLL(str(so))
    lib.slam_k6_phases.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(19)
    for S in (1, 8):
        shares = (0.8,) if S == 1 else cs.K6_BATCHED_VALID
        q, k, v = [torch.from_numpy(rng.normal(size=(S, 2400, 4, 32)).astype(np.float32)).to(dev)
                   for _ in range(3)]
        mask = torch.from_numpy(np.stack([rng.random(2400) < f for f in shares])).to(dev)
        operands = (q, k, v, mask) if S > 1 else (q[0], k[0], v[0], mask[0])
        for pad in (int(x) for x in args.pads.split(",")):
            os.environ["K6_PAD"] = str(pad)
            for fold in ((False,) if S == 1 else (False, True)):
                call = kernel_ab.k6_caller(lib, "fold", 0, fold)
                ms = cs.cuda_ms(lambda: call(*operands))
                counts = (ctypes.c_ulonglong * 5)()
                lib.slam_k6_phases(counts)  # reset
                call(*operands)
                torch.cuda.synchronize()
                lib.slam_k6_phases(counts)
                tiles = max(counts[4], 1)
                cycles = ", ".join(f"{name} {counts[i] / tiles:.0f}" for i, name in
                                   enumerate(PHASES))
                kernels = kernel_ab.profile_kernels(lambda: call(*operands), n=10)
                print(f"S={S} pad={pad} fold={fold}: {ms:.4f} ms; cycles a tile of the first "
                      f"CTA ({tiles} tiles): {cycles}; kernels us {kernels}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
