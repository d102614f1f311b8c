"""A/B device time of kernel K2 (the guided matcher) built from several
source trees, on the classical path's own K2 inputs.

Run from the repository root on one CUDA card:

    python3 -m racing_slam_tpu_torch.tools.match_ab --csrc NAME=DIR [--csrc NAME=DIR ...]

Each DIR holds a ``match_kernel.cu`` and the headers it includes; each is
built by its own nvcc process (the flags of ``ops/kernels/_build.py``) into
``build/match_ab/NAME.so``. The classical path of ``chip_smoke.py``
(seed-3 304-frame bench world, P=4096, K=2400, D=128) is driven once through
the port while its K2 calls are recorded: the first ``--calls`` calls' inputs
are copied on the card. Every build then replays all recorded calls back to
back, each launch between two CUDA events, in rounds ordered A B ... B A
(``--rounds`` times), so each build's sum of kernel times is taken under the
same clocks as the others'. Prints one JSON line per build: the median and
every round's sum of kernel times in ms, microseconds per call, and its
agreement with K2's plain twin over all calls (keypoint choices equal,
largest distance error where they are); before that, each build's
registers, stack and spills per kernel instance (ptxas -v).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def build(name: str, csrc: Path) -> tuple[Path, subprocess.Popen]:
    """Start nvcc on DIR/match_kernel.cu; (library path, the process)."""
    from ..ops.kernels import _build

    out = REPO / "build" / "match_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    return out, subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(csrc),
         "-o", str(out),
         str(csrc / "match_kernel.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def launcher(so: Path, csrc: Path):
    """fn(args, best_k, best_d, stream) -> int for one build; the builds
    before the device `skip` flag take one pointer fewer."""
    lib = ctypes.CDLL(str(so))
    fn = lib.slam_guided_match
    has_skip = "skip" in (csrc / "match_kernel.cu").read_text()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * (10 if has_skip else 9) + [I, I, I, I, F, P]
    fn.restype = ctypes.c_int

    def call(a, bk, bd, radius_px, stream):
        uv_p, gate, obs, ov, kuv, kd, kok = a
        Pn, O, D = obs.shape
        ptrs = [t.data_ptr() for t in (uv_p, gate, obs, ov, kuv, kd, kok)]
        if has_skip:
            ptrs.append(None)
        return fn(*ptrs, bk.data_ptr(), bd.data_ptr(), Pn, O, D, kuv.shape[0],
                  float(radius_px * radius_px), stream)

    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", required=True, help="NAME=DIR")
    ap.add_argument("--calls", type=int, default=192, help="K2 calls to record (2 a frame)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("match_ab: no CUDA device", file=sys.stderr)
        return 1
    variants = {}
    for spec in args.csrc:
        name, d = spec.split("=", 1)
        variants[name] = Path(d).resolve()
    procs = {name: build(name, d) for name, d in variants.items()}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
        # ptxas -v: each kernel instance's registers, stack and spills.
        for entry in log.split("Compiling entry function")[1:]:
            mangled = entry.split("'")[1]
            inst = ("DPL=8" if "ILi8E" in mangled else "DPL=4") + (
                " skip" if "Lb1E" in mangled else "")
            usage = [ln.split(":", 1)[-1].strip() for ln in entry.splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"{name} {inst}: {'; '.join(usage)}", flush=True)

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    from ..ops import matching
    from ..ops.camera import Camera
    from ..ops.kernels import (attention, frontend, match, match_banded, motion_ba,
                               structure_ba)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
    frames, gt = cs.render_bench_world(cs.SEED, cam, cs.N_FRAMES)

    recorded = []
    port_k2 = matching.guided_match_stage1

    def recording(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, radius_px=20.0,
                  skip=None):
        if len(recorded) < args.calls and skip is None:
            recorded.append(([t.clone() for t in (uv_p, gate_p, obs_desc.to(torch.bfloat16),
                                                  obs_valid, kp_uv, kp_desc.float(), kp_ok)],
                             radius_px))
        return port_k2(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok,
                       radius_px=radius_px, skip=skip)

    matching.guided_match_stage1 = recording
    kernels = [dict(name=n, module=m) for n, m in [
        ("corner_frontend_fused", frontend), ("guided_match_stage1", match),
        ("motion_ba_lm", motion_ba), ("structure_ba_lm", structure_ba),
        ("guided_match_stage1_banded", match_banded), ("flash_mha", attention)]]
    cs.run_path("classical", dev, kernels, cam, frames, gt)
    matching.guided_match_stage1 = port_k2
    n = len(recorded)
    gated = [int(a[1].sum()) for a, _ in recorded]
    print(f"recorded {n} K2 calls of the classical path; gated points a call "
          f"{min(gated)}-{max(gated)} (mean {np.mean(gated):.0f})", flush=True)

    twin = [match.guided_match_stage1_reference(*a, radius_px=r) for a, r in recorded]
    outs = [(torch.empty(a[0].shape[0], dtype=torch.int32, device=dev),
             torch.empty(a[0].shape[0], dtype=torch.float32, device=dev)) for a, _ in recorded]
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {name: launcher(procs[name][0], d) for name, d in variants.items()}
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(n)]

    def replay(call) -> float:
        for (a, r), (bk, bd), (e0, e1) in zip(recorded, outs, evs):
            e0.record()
            err = call(a, bk, bd, r, stream)
            e1.record()
            assert err == 0, f"launch error {err}"
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in evs)

    results = {}
    for name, call in calls.items():
        replay(call)  # warm-up
        same, total, err = 0, 0, 0.0
        for (bk, bd), (rk, rd) in zip(outs, twin):
            eq = bk == rk
            same += int(eq.sum())
            total += eq.numel()
            if bool(eq.any()):
                err = max(err, float((bd[eq] - rd[eq]).abs().max()))
        results[name] = dict(agreement=same / total, differing=total - same, max_abs_err=err,
                             rounds_ms=[])
    order = list(calls) + list(reversed(calls))
    for _ in range(args.rounds):
        for name in order:
            results[name]["rounds_ms"].append(replay(calls[name]))
    for name, res in results.items():
        med = float(np.median(res["rounds_ms"]))
        print("match_ab " + json.dumps(dict(build=name, calls=n, median_ms=med,
                                            us_per_call=1e3 * med / n, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
