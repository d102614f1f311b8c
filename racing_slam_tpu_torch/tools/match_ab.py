"""A/B device time of kernels K2 (the guided matcher) and K3 (motion-only
BA) built from several source trees, on a path's own inputs.

Run from the repository root on one CUDA card:

    python3 -m racing_slam_tpu_torch.tools.match_ab --csrc NAME=DIR [--csrc NAME=DIR ...]
        [--path classical|learned|lightglue|headline] [--worlds DIR]

Each DIR holds ``match_kernel.cu``, ``motion_ba_kernel.cu`` and the headers
they include; each tree's two sources are built by their own nvcc processes
(all started together, the flags of ``ops/kernels/_build.py``) and linked
into ``build/match_ab/NAME.so``. A path of ``chip_smoke.py`` (``--path``,
by default the classical one: seed-3 304-frame bench world, P=4096,
K=2400, D=128; ``learned`` gives K2 SuperPoint's D=256) is driven once
through the port while its K2 calls and its K3 solves (``motion_ba_lm``'s
inputs and ``max_iters``) are recorded: the first ``--calls`` of each are
copied on the card. Every build then replays all recorded K2 calls back to
back, then all K3 solves, each launch between two CUDA events, the stream
held by a sleep kernel while the host enqueues them (so the times are the
device's, not the host's), in rounds ordered A B ... B A (``--rounds``
times), so each build's sums are taken under the same clocks as the
others'. Prints one JSON line per build and kernel: the median and every
round's sum of kernel times in ms, microseconds per call, and agreement
with the kernel's plain twin over all calls (K2: keypoint choices equal,
largest distance error where they are; K3: largest pose error, largest
relative cost difference, mean iterations a solve of the build and of the
twin, the calls whose iteration counts differ by more than 1); before
that, each build's registers, stack and spills per kernel instance
(ptxas -v).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
SOURCES = ("match_kernel.cu", "motion_ba_kernel.cu")
ENTRY_POINTS = ("slam_guided_match", "slam_motion_ba")


def build(name: str, csrc: Path) -> tuple[Path, str]:
    """Compile and link one tree; (library path, ptxas log)."""
    from ..ops.kernels import _build

    out_dir = REPO / "build" / "match_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    objs = [out_dir / f"{name}.{Path(src).stem}.o" for src in SOURCES]
    # Each build's entry points get names of their own, so that no build
    # can answer for another (or for the port's own library, loaded too).
    rename = [f"-D{fn}=ab_{name}_{fn}" for fn in ENTRY_POINTS]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *rename, "-Xptxas", "-v", "-I",
                               str(csrc), "-c", "-o", str(obj), str(csrc / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(SOURCES, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"{name}/{src}: nvcc failed ({p.returncode}):\n{log}")
    so = out_dir / f"{name}.so"
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), *map(str, objs)],
                   check=True)
    return so, "".join(logs)


def register_lines(name: str, log: str) -> list[str]:
    """ptxas -v: each kernel instance's registers, stack and spills."""
    out = []
    for entry in log.split("Compiling entry function")[1:]:
        mangled = entry.split("'")[1]
        kernel = "K3" if "motion_ba" in mangled else "K2"
        usage = [ln.split(":", 1)[-1].strip() for ln in entry.splitlines()
                 if "registers" in ln or "spill" in ln]
        out.append(f"{name} {kernel} {mangled[-40:]}: {'; '.join(usage)}")
    return out


def launchers(name: str, so: Path, csrc: Path):
    """(k2(args, bk, bd, radius, stream), k3(args, out, kw, stream)) for one
    build; the K2 builds before the device `skip` flag take one pointer
    fewer. The library binds its own symbols first (RTLD_DEEPBIND)."""
    lib = ctypes.CDLL(str(so), mode=os.RTLD_LOCAL | os.RTLD_DEEPBIND)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    k2 = getattr(lib, f"ab_{name}_slam_guided_match")
    has_skip = "skip" in (csrc / "match_kernel.cu").read_text()
    k2.argtypes = [P] * (10 if has_skip else 9) + [I, I, I, I, F, P]
    k2.restype = ctypes.c_int
    k3 = getattr(lib, f"ab_{name}_slam_motion_ba")
    k3.argtypes = [P, P, P, P, P, I, F, F, F, F, F, F, I, P]
    k3.restype = ctypes.c_int

    def call2(a, bk, bd, radius_px, stream):
        uv_p, gate, obs, ov, kuv, kd, kok = a
        Pn, O, D = obs.shape
        ptrs = [t.data_ptr() for t in (uv_p, gate, obs, ov, kuv, kd, kok)]
        if has_skip:
            ptrs.append(None)
        return k2(*ptrs, bk.data_ptr(), bd.data_ptr(), Pn, O, D, kuv.shape[0],
                  float(radius_px * radius_px), stream)

    def call3(a, out, kw, stream):
        pose0, uv, xyz, valid = a
        return k3(pose0.data_ptr(), uv.data_ptr(), xyz.data_ptr(), valid.data_ptr(),
                  out.data_ptr(), uv.shape[0], kw["fx"], kw["cx"], kw["cy"], kw["init_lambda"],
                  kw["huber_delta"], kw["ftol"], kw["max_iters"], stream)

    return call2, call3


def replay(calls: list, evs: list) -> float:
    """Enqueue every call behind a sleep kernel long enough for the host to
    get ahead, each between two events; the sum of their device times."""
    t0 = time.perf_counter()
    for fn in calls[:8]:
        fn()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / min(8, len(calls))
    torch.cuda._sleep(int(min(2.0 * per_call * len(calls), 0.5) * 2e9))
    for fn, (e0, e1) in zip(calls, evs):
        e0.record()
        err = fn()
        e1.record()
        assert err == 0, f"launch error {err}"
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in evs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", required=True, help="NAME=DIR")
    ap.add_argument("--calls", type=int, default=192, help="calls of each kernel to record "
                    "(2 a frame)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--path", default="classical",
                    choices=("classical", "learned", "lightglue", "headline"))
    ap.add_argument("--worlds", type=Path, default=None,
                    help="directory of rendered worlds (tools/path_seeds.py)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("match_ab: no CUDA device", file=sys.stderr)
        return 1
    variants = {}
    for spec in args.csrc:
        name, d = spec.split("=", 1)
        variants[name] = Path(d).resolve()
    built = {name: build(name, d) for name, d in variants.items()}
    for name, (_, log) in built.items():
        for line in register_lines(name, log):
            print(line, flush=True)

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
    if args.worlds is None:
        frames, gt = cs.render_bench_world(cs.SEED, cam, cs.N_FRAMES)
    else:
        from .path_seeds import worlds

        frames, gt = worlds([cs.SEED], cs.N_FRAMES, args.worlds)[cs.SEED]

    rec2, rec3 = [], []
    port_k2, port_k3 = matching.guided_match_stage1, motion_ba.motion_ba_lm

    def recording_k2(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, radius_px=20.0,
                     skip=None):
        if len(rec2) < args.calls and skip is None:
            rec2.append(([t.clone() for t in (uv_p, gate_p, obs_desc.to(torch.bfloat16),
                                              obs_valid, kp_uv, kp_desc.float(), kp_ok)],
                         radius_px))
        return port_k2(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok,
                       radius_px=radius_px, skip=skip)

    def recording_k3(pose0, kp_uv, point_xyz, valid, **kw):
        if len(rec3) < args.calls:
            full = {"ftol": motion_ba.FUNCTION_TOLERANCE, "init_lambda": 1e-4, **kw}
            rec3.append(([t.clone() for t in (pose0, kp_uv, point_xyz, valid)], full))
        return port_k3(pose0, kp_uv, point_xyz, valid, **kw)

    matching.guided_match_stage1, motion_ba.motion_ba_lm = recording_k2, recording_k3
    kernels = [dict(name=n, module=m) for n, m in [
        ("corner_frontend_fused", frontend), ("guided_match_stage1", match),
        ("motion_ba_lm", motion_ba), ("structure_ba_lm", structure_ba),
        ("guided_match_stage1_banded", match_banded), ("flash_mha", attention)]]
    try:
        cs.run_path(args.path, dev, kernels, cam, frames, gt)
    finally:
        matching.guided_match_stage1, motion_ba.motion_ba_lm = port_k2, port_k3
    gated = [int(a[1].sum()) for a, _ in rec2]
    rows = [int(a[3].sum()) for a, _ in rec3]
    print(f"recorded {len(rec2)} K2 calls of the {args.path} path (D="
          f"{rec2[0][0][2].shape[-1]}); gated points a call "
          f"{min(gated)}-{max(gated)} (mean {np.mean(gated):.0f}); {len(rec3)} K3 solves, valid "
          f"rows {min(rows)}-{max(rows)} (mean {np.mean(rows):.0f}), max_iters "
          f"{sorted({kw['max_iters'] for _, kw in rec3})}", flush=True)

    twin2 = [match.guided_match_stage1_reference(*a, radius_px=r) for a, r in rec2]
    twin3 = [motion_ba.motion_ba_lm_reference(*a, **kw) for a, kw in rec3]
    outs2 = [(torch.empty(a[0].shape[0], dtype=torch.int32, device=dev),
              torch.empty(a[0].shape[0], dtype=torch.float32, device=dev)) for a, _ in rec2]
    outs3 = [torch.empty(8, dtype=torch.float32, device=dev) for _ in rec3]
    stream = torch.cuda.current_stream(dev).cuda_stream
    jobs = {}
    for name, d in variants.items():
        call2, call3 = launchers(name, built[name][0], d)
        jobs[(name, "K2")] = [(lambda a=a, r=r, o=o, f=call2: f(a, o[0], o[1], r, stream))
                              for (a, r), o in zip(rec2, outs2)]
        jobs[(name, "K3")] = [(lambda a=a, kw=kw, o=o, f=call3: f(a, o, kw, stream))
                              for (a, kw), o in zip(rec3, outs3)]
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(max(len(rec2), len(rec3)))]

    results = {}
    for (name, kern), calls in jobs.items():
        replay(calls, evs)  # warm-up, and the outputs compared below
        if kern == "K2":
            same, total, err = 0, 0, 0.0
            for (bk, bd), (rk, rd) in zip(outs2, twin2):
                eq = bk == rk
                same += int(eq.sum())
                total += eq.numel()
                if bool(eq.any()):
                    err = max(err, float((bd[eq] - rd[eq]).abs().max()))
            agree = dict(agreement=same / total, differing=total - same, max_abs_err=err)
        else:
            got, ref = torch.stack(outs3).cpu().numpy(), torch.stack(twin3).cpu().numpy()
            agree = dict(max_pose_err=float(np.abs(got[:, :6] - ref[:, :6]).max()),
                         max_cost_rel=float((np.abs(got[:, 6] - ref[:, 6])
                                             / np.maximum(ref[:, 6], 1e-30)).max()),
                         iterations=float(got[:, 7].mean()),
                         twin_iterations=float(ref[:, 7].mean()),
                         iterations_apart=int((np.abs(got[:, 7] - ref[:, 7]) > 1).sum()))
        results[(name, kern)] = dict(agree, rounds_ms=[])
    names = list(variants)
    order = names + names[::-1]
    for _ in range(args.rounds):
        for name in order:
            for kern in ("K2", "K3"):
                results[(name, kern)]["rounds_ms"].append(
                    replay(jobs[(name, kern)], evs[:len(jobs[(name, kern)])]))
    for (name, kern), res in results.items():
        n = len(jobs[(name, kern)])
        med = float(np.median(res["rounds_ms"]))
        print("match_ab " + json.dumps(dict(build=name, kernel=kern, calls=n, median_ms=med,
                                            us_per_call=1e3 * med / n, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
