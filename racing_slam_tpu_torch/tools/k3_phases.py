"""Where an LM iteration of kernel K3 spends its cycles, on one CUDA card.

Run from the repository root:

    python3 -m racing_slam_tpu_torch.tools.k3_phases [--csrc DIR] [--seqs 1,8]

Builds a copy of ``motion_ba_kernel.cu`` from DIR (by default the port's
``csrc/``; under ``build/k3_phases``) with clock64() probes in thread 0 of
the first CTA of the last cluster (the last sequence's solve) around the
phases of an iteration: the pass over the CTA's rows (`pass`); the
reduction, as the warp sums (`sums`), their stores into the cluster's
slots and the wait for the pass's barrier (`barrier`: it waits for the
cluster's slowest CTA, so it holds the imbalance) and the sum of the slots
(`totals`); and the decision, the 6x6 solve and the trial pose's transform
(`solve`). Then runs ``chip_smoke.check_motion_ba_batched``'s problems
(``_k3_data`` with seeds 11, 12, ...: K = 2400, the tolerance exit on) at
each S of ``--seqs`` and prints for each: ms a launch
(``chip_smoke.cuda_ms``), the probed thread's passes and iterations, the
cycles a pass of `pass` and of each part of the reduction, and the cycles
a solve of `solve`. The probes do not change the kernel's arithmetic; they
are read after one launch.
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
PHASES = ("pass", "sums", "barrier", "totals", "solve")

# (text of the kernel, text it becomes): the probes. ph[0..4] are the
# phases' cycles, ph[5] the solves, ph[6] the passes.
PATCHES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_phase[7];\n"),
    ("  auto pass = [&](const float (&xf)[21], int p) -> float {\n",
     "  const bool probe = blockIdx.x == 0 && blockIdx.y == gridDim.y - 1 && threadIdx.x == 0;\n"
     "  long long ph[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  auto pass = [&](const float (&xf)[21], int p) -> float {\n"
     "    const long long q0 = clock64();\n"),
    ("    const float mine = warp_sums(acc, lane);\n",
     "    const long long q1 = clock64();\n    const float mine = warp_sums(acc, lane);\n"
     "    const long long q2 = clock64();\n"),
    ("    wait_phase(bar, (p >> 1) & 1);",
     "    wait_phase(bar, (p >> 1) & 1);\n    const long long q3 = clock64();"),
    ("    return total;\n  };\n",
     "    if (probe) {\n      ph[0] += q1 - q0;\n      ph[1] += q2 - q1;\n      ph[2] += q3 - q2;\n"
     "      ph[3] += clock64() - q3;\n      ++ph[6];\n    }\n    return total;\n  };\n"),
    ("    float H[36], g[6], x[6], trial[6];\n",
     "    float H[36], g[6], x[6], trial[6];\n    const long long s0 = clock64();\n"),
    ("    pose_transform(trial, xf);\n    const float tot",
     "    pose_transform(trial, xf);\n    if (probe) {\n      ph[4] += clock64() - s0;\n"
     "      ++ph[5];\n    }\n    const float tot"),
    ("  // Every store into this CTA's shared memory has landed",
     "  if (probe)\n    for (int i = 0; i < 7; ++i) g_phase[i] += ph[i];\n"
     "  // Every store into this CTA's shared memory has landed"),
]
READER = """
SLAM_API int slam_k3_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=str(REPO / "racing_slam_tpu_torch" / "csrc"))
    ap.add_argument("--seqs", default="1,8", help="solves a launch, e.g. 1,8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    tree = kernel_ab.patched_tree("k3_phases", Path(args.csrc).resolve(), "motion_ba_kernel.cu",
                                  PATCHES, READER)
    so, log = kernel_ab.build("k3_phases", tree, ("k3",))
    for row in kernel_ab.ptxas_usage(log):
        print(f"k3_phases {row}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.slam_k3_phases.argtypes = [ctypes.c_void_p]
    call = kernel_ab.k3_caller(lib)
    dev = torch.device("cuda", 0)
    seqs = [int(x) for x in args.seqs.split(",")]
    data = [cs._k3_data(np.random.default_rng(11 + i), dev) for i in range(max(seqs))]
    kw = data[0][1]
    for S in seqs:
        operands = [torch.stack([d[0][j] for d in data[:S]]) for j in range(4)]
        ms = cs.cuda_ms(lambda: call(operands, kw))
        counts = (ctypes.c_ulonglong * 7)()
        lib.slam_k3_phases(counts)  # reset
        out = call(operands, kw)
        torch.cuda.synchronize()
        lib.slam_k3_phases(counts)
        passes, solves = max(counts[6], 1), max(counts[5], 1)
        per = ", ".join(f"{name} {counts[i] / passes:.0f}" for i, name in enumerate(PHASES[:4]))
        print(f"S={S}: {ms:.4f} ms a launch; iterations {out[:, 7].int().tolist()}; the first "
              f"CTA's thread 0: {counts[6]} passes, {counts[5]} solves; cycles a pass: {per}; "
              f"a solve: {counts[4] / solves:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
