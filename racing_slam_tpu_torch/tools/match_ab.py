"""A/B device time of kernels K1 (the image stack), K2 (the guided
matcher), K3 (motion-only BA) and K5 (the banded matcher) built from
several source trees, on a path's own inputs.

Run from the repository root on one CUDA card:

    python3 -m racing_slam_tpu_torch.tools.match_ab --csrc NAME=DIR [--csrc NAME=DIR ...]
        [--kernels k2,k3] [--path classical|learned|lightglue|headline] [--worlds DIR]

Each DIR holds the kernels' sources (``frontend_kernel.cu``,
``match_kernel.cu``, ``motion_ba_kernel.cu``, ``match_banded_kernel.cu``)
and the headers they include; each tree's sources of the ``--kernels``
asked for are built by their own nvcc processes (all started together, the
flags of ``ops/kernels/_build.py``) and linked into
``build/match_ab/NAME.so``. Each build's entry points get names of their
own at compile time (``-Dslam_guided_match=ab_NAME_slam_guided_match``), so
that no build can answer for another. The port then runs a path of
``chip_smoke.py`` while it records the first ``--calls`` inputs of each
kernel, copied on the card: K1 frames, K2 calls and K3 solves
(``motion_ba_lm``'s inputs and ``max_iters``) on ``--path`` (by default
the classical one: seed-3 304-frame bench world, P=4096, K=2400, D=128;
``learned`` gives K2 SuperPoint's D=256), K5 calls on the ``scale`` path
(150 frames, P=16384). A K5 tree whose kernel predates the p_sel contract
(it reads gathered rows) is given the recorded rows gathered once, outside
the timing, as ``band_plan`` gathered them.

Every build then replays each kernel's recorded calls back to back, each
launch between two CUDA events, the stream held by a sleep kernel while
the host enqueues them (so the times are the device's, not the host's),
in rounds ordered A B ... B A (``--rounds`` times), so that each build's
sums are taken under the same clocks as the others'. Prints one JSON line
per build and kernel: the median and every round's sum of kernel times in
ms, microseconds per call, and agreement with the kernel's plain twin over
all calls (K1: largest response and blur errors, largest share of pixels
whose peak status differs; K2 and K5: keypoint choices equal, largest
distance error where they are; K3: largest pose error, largest relative
cost difference, mean iterations a solve of the build and of the twin,
the calls whose iteration counts differ by more than 1); before that,
each build's registers, stack and spills per kernel instance (ptxas -v).
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
# kernel: (source, entry point, name of its __global__ function)
KERNELS = {
    "k1": ("frontend_kernel.cu", "slam_frontend", "frontend_kernel"),
    "k2": ("match_kernel.cu", "slam_guided_match", "guided_match_kernel"),
    "k3": ("motion_ba_kernel.cu", "slam_motion_ba", "motion_ba"),
    "k5": ("match_banded_kernel.cu", "slam_guided_match_banded", "banded_match_kernel"),
}


def build(name: str, csrc: Path, kernels: list) -> tuple[Path, str]:
    """Compile and link one tree's `kernels`; (library path, ptxas log)."""
    from ..ops.kernels import _build

    out_dir = REPO / "build" / "match_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    sources = [KERNELS[k][0] for k in kernels]
    objs = [out_dir / f"{name}.{Path(src).stem}.o" for src in sources]
    rename = [f"-D{fn}=ab_{name}_{fn}" for fn in [KERNELS[k][1] for k in kernels]
              + ["slam_error_string"]]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *rename, "-Xptxas", "-v", "-I",
                               str(csrc), "-c", "-o", str(obj), str(csrc / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(sources, procs, logs):
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
        kernel = next((k.upper() for k, v in KERNELS.items() if v[2] in mangled), "?")
        usage = [ln.split(":", 1)[-1].strip() for ln in entry.splitlines()
                 if "registers" in ln or "spill" in ln]
        out.append(f"{name} {kernel} {mangled[-40:]}: {'; '.join(usage)}")
    return out


def launchers(name: str, so: Path, csrc: Path, kernels: list) -> dict:
    """{kernel: call(recorded args, outputs, stream)} for one build; the K2
    builds before the device `skip` flag take one pointer fewer, the K5
    builds before p_sel take gathered rows, and those with a sequence axis
    take S = 1 before the sizes. The library binds its own
    symbols first (RTLD_DEEPBIND)."""
    lib = ctypes.CDLL(str(so), mode=os.RTLD_LOCAL | os.RTLD_DEEPBIND)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def fn(k, argtypes):
        f = getattr(lib, f"ab_{name}_{KERNELS[k][1]}")
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        return f

    calls = {}
    if "k1" in kernels:
        k1 = fn("k1", [P, P, P, P, P, I, I, I, P, I, P, I, I, P])

        def call1(a, out, stream):
            img, mask, t1, t2, border = a
            B, H, W = img.shape
            return k1(img.data_ptr(), None if mask is None else mask.data_ptr(),
                      *[t.data_ptr() for t in out], B, H, W, t1.ctypes.data, 4, t2.ctypes.data,
                      6, border, stream)
        calls["k1"] = call1
    if "k2" in kernels:
        src2 = (csrc / KERNELS["k2"][0]).read_text()
        has_skip = "skip" in src2
        batched2 = "blockIdx.y" in src2  # the build takes S problems (one here)
        k2 = fn("k2", [P] * (10 if has_skip else 9) + [I] * (5 if batched2 else 4) + [F, P])

        def call2(a, out, stream):
            (uv_p, gate, obs, ov, kuv, kd, kok), radius_px = a
            Pn, O, D = obs.shape
            ptrs = [t.data_ptr() for t in (uv_p, gate, obs, ov, kuv, kd, kok)]
            if has_skip:
                ptrs.append(None)
            return k2(*ptrs, out[0].data_ptr(), out[1].data_ptr(), *([1] if batched2 else []),
                      Pn, O, D, kuv.shape[0], float(radius_px * radius_px), stream)
        calls["k2"] = call2
    if "k3" in kernels:
        batched3 = "blockIdx.x" in (csrc / KERNELS["k3"][0]).read_text()  # takes S solves
        k3 = fn("k3", [P, P, P, P, P] + [I] * (2 if batched3 else 1) + [F] * 6 + [I, P])

        def call3(a, out, stream):
            (pose0, uv, xyz, valid), kw = a
            return k3(pose0.data_ptr(), uv.data_ptr(), xyz.data_ptr(), valid.data_ptr(),
                      out.data_ptr(), *([1] if batched3 else []), uv.shape[0], kw["fx"], kw["cx"],
                      kw["cy"],
                      kw["init_lambda"], kw["huber_delta"], kw["ftol"], kw["max_iters"], stream)
        calls["k3"] = call3
    if "k5" in kernels:
        src5 = (csrc / KERNELS["k5"][0]).read_text()
        reads_p_sel = "p_sel" in src5
        batched5 = "blockIdx.y" in src5  # the sequence axis: S before the sizes
        k5 = fn("k5", [P] * (12 if reads_p_sel else 11)
                + [I] * ((8 if reads_p_sel else 7) + batched5) + [F, P])

        def call5(a, out, stream):
            args, gathered, tiles = a
            uv_p, gate, obs, ov, p_sel, kuv, kd, kok, starts, n_act = args
            Pn, O, D = obs.shape
            G = p_sel.shape[0]
            rows = (uv_p, gate, obs, ov, p_sel) if reads_p_sel else gathered
            sizes = ((1,) if batched5 else ()) + ((Pn, G) if reads_p_sel else (G,))
            return k5(*[t.data_ptr() for t in (*rows, kuv, kd, kok, starts, n_act, *out)],
                      *sizes, O, D, kuv.shape[0], tiles["tile_p"], tiles["tile_k"],
                      tiles["band_tiles"], float(tiles["radius_px"] ** 2), stream)
        calls["k5"] = call5
    return calls


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


def record(args, kernels: list, dev, cam, cs) -> dict:
    """Run the paths the kernels need with recorders in front of the port's
    wrappers; {kernel: [recorded call]}."""
    from ..ops import matching
    from ..ops.kernels import (attention, frontend, match, match_banded, motion_ba,
                               structure_ba)
    from ..slam import frontend as slam_frontend

    rec = {k: [] for k in kernels}
    port = dict(k1=slam_frontend.corner_frontend_fused, k2=matching.guided_match_stage1,
                k3=motion_ba.motion_ba_lm, k5=matching.guided_match_stage1_banded)

    def recording_k1(img, mask=None, **kw):
        if "k1" in rec and len(rec["k1"]) < args.calls and not kw:
            k1 = np.asarray(frontend.gaussian_kernel1d(1.2), np.float32)
            k2 = np.asarray(frontend.gaussian_kernel1d(2.0), np.float32)
            frames = img[None] if img.dim() == 2 else img
            rec["k1"].append((frames.clone(), None if mask is None else mask.clone(), k1, k2, 8))
        return port["k1"](img, mask, **kw)

    def recording_k2(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, radius_px=20.0,
                     skip=None):
        if "k2" in rec and len(rec["k2"]) < args.calls and skip is None:
            rec["k2"].append(([t.clone() for t in (uv_p, gate_p, obs_desc.to(torch.bfloat16),
                                                   obs_valid, kp_uv, kp_desc.float(), kp_ok)],
                              radius_px))
        return port["k2"](uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok,
                          radius_px=radius_px, skip=skip)

    def recording_k3(pose0, kp_uv, point_xyz, valid, **kw):
        if "k3" in rec and len(rec["k3"]) < args.calls:
            full = {"ftol": motion_ba.FUNCTION_TOLERANCE, "init_lambda": 1e-4, **kw}
            rec["k3"].append(([t.clone() for t in (pose0, kp_uv, point_xyz, valid)], full))
        return port["k3"](pose0, kp_uv, point_xyz, valid, **kw)

    def recording_k5(*a, **tiles):
        if "k5" in rec and len(rec["k5"]) < args.calls:
            t = [x.clone() for x in a]
            t[2], t[6] = t[2].to(torch.bfloat16), t[6].float()
            uv_p, gate, obs, ov, p_sel = t[:5]
            src = torch.clamp(p_sel.long(), 0, obs.shape[0] - 1)
            gathered = (uv_p[src].contiguous(), (gate[src] & (p_sel < obs.shape[0])).contiguous(),
                        obs[src].contiguous(), ov[src].contiguous())
            rec["k5"].append((t, gathered, tiles))
        return port["k5"](*a, **tiles)

    kmods = [dict(name=n, module=m) for n, m in [
        ("corner_frontend_fused", frontend), ("guided_match_stage1", match),
        ("motion_ba_lm", motion_ba), ("structure_ba_lm", structure_ba),
        ("guided_match_stage1_banded", match_banded), ("flash_mha", attention)]]
    (slam_frontend.corner_frontend_fused, matching.guided_match_stage1, motion_ba.motion_ba_lm,
     matching.guided_match_stage1_banded) = recording_k1, recording_k2, recording_k3, recording_k5
    try:
        paths = ([args.path] if set(kernels) & {"k1", "k2", "k3"} else []) + \
            (["scale"] if "k5" in kernels else [])
        for path in paths:
            n_frames = cs.PATHS[path][2]
            if args.worlds is None:
                frames, gt = cs.render_bench_world(cs.SEED, cam, n_frames)
            else:
                from .path_seeds import worlds

                frames, gt = worlds([cs.SEED], n_frames, args.worlds)[cs.SEED]
            cs.run_path(path, dev, kmods, cam, frames, gt)
    finally:
        (slam_frontend.corner_frontend_fused, matching.guided_match_stage1,
         motion_ba.motion_ba_lm, matching.guided_match_stage1_banded) = (
            port["k1"], port["k2"], port["k3"], port["k5"])
    return rec


def twins_and_outputs(rec: dict, dev) -> tuple[dict, dict]:
    """Each recorded call's twin result and output buffers."""
    from ..ops.kernels import frontend, match, match_banded, motion_ba

    twins, outs = {}, {}
    for k, calls in rec.items():
        if k == "k1":
            twins[k] = [frontend.corner_frontend_fused_reference(img, mask) for img, mask, *_ in
                        calls]
            outs[k] = [[torch.empty_like(img) for _ in range(3)] for img, *_ in calls]
        elif k == "k2":
            twins[k] = [match.guided_match_stage1_reference(*a, radius_px=r) for a, r in calls]
            outs[k] = [(torch.empty(a[0].shape[0], dtype=torch.int32, device=dev),
                        torch.empty(a[0].shape[0], dtype=torch.float32, device=dev))
                       for a, _ in calls]
        elif k == "k3":
            twins[k] = [motion_ba.motion_ba_lm_reference(*a, **kw) for a, kw in calls]
            outs[k] = [torch.empty(8, dtype=torch.float32, device=dev) for _ in calls]
        else:
            twins[k] = [match_banded.guided_match_stage1_banded_reference(*a, **tiles)
                        for a, _, tiles in calls]
            outs[k] = [(torch.empty(a[4].shape[0], dtype=torch.int32, device=dev),
                        torch.empty(a[4].shape[0], dtype=torch.float32, device=dev))
                       for a, _, _ in calls]
    return twins, outs


def agreement(k: str, outs: list, twins: list) -> dict:
    """How a build's outputs of one kernel agree with the twin's."""
    if k == "k1":
        err_r = err_b = flips = 0.0
        for (r, p, b), (r0, p0, b0) in zip(outs, twins):
            err_r = max(err_r, float((r - r0).abs().max()))
            err_b = max(err_b, float((b - b0).abs().max()))
            flips = max(flips, float(((p > 0) != (p0 > 0)).float().mean()))
        return dict(max_resp_err=err_r, max_blur_err=err_b, max_peak_flip_share=flips)
    if k in ("k2", "k5"):
        same, total, err = 0, 0, 0.0
        for (bk, bd), (rk, rd) in zip(outs, twins):
            hit = rd < 1e9
            eq = (bk == rk) & hit
            same += int(eq.sum())
            total += int(hit.sum())
            if bool(eq.any()):
                err = max(err, float((bd[eq] - rd[eq]).abs().max()))
        return dict(agreement=same / max(total, 1), differing=total - same, max_abs_err=err)
    got, ref = torch.stack(outs).cpu().numpy(), torch.stack(twins).cpu().numpy()
    return dict(max_pose_err=float(np.abs(got[:, :6] - ref[:, :6]).max()),
                max_cost_rel=float((np.abs(got[:, 6] - ref[:, 6])
                                    / np.maximum(ref[:, 6], 1e-30)).max()),
                iterations=float(got[:, 7].mean()), twin_iterations=float(ref[:, 7].mean()),
                iterations_apart=int((np.abs(got[:, 7] - ref[:, 7]) > 1).sum()))


def describe(k: str, calls: list) -> str:
    if k == "k1":
        return f"{len(calls)} K1 frames of {tuple(calls[0][0].shape)}"
    if k == "k2":
        gated = [int(a[1].sum()) for a, _ in calls]
        return (f"{len(calls)} K2 calls (D={calls[0][0][2].shape[-1]}); gated points a call "
                f"{min(gated)}-{max(gated)} (mean {np.mean(gated):.0f})")
    if k == "k3":
        rows = [int(a[3].sum()) for a, _ in calls]
        return (f"{len(calls)} K3 solves, valid rows {min(rows)}-{max(rows)} (mean "
                f"{np.mean(rows):.0f}), max_iters {sorted({kw['max_iters'] for _, kw in calls})}")
    gated = [int(g[1].sum()) for _, g, _ in calls]
    act = [int(a[9]) for a, _, _ in calls]
    return (f"{len(calls)} K5 calls of the scale path; gated rows a call {min(gated)}-"
            f"{max(gated)} (mean {np.mean(gated):.0f}), active tiles {min(act)}-{max(act)}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", required=True, help="NAME=DIR")
    ap.add_argument("--kernels", default="k2,k3", help="any of k1,k2,k3,k5")
    ap.add_argument("--calls", type=int, default=192, help="calls of each kernel to record")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--path", default="classical",
                    choices=("classical", "learned", "lightglue", "headline"),
                    help="the path whose K1, K2 and K3 calls are recorded (K5: scale)")
    ap.add_argument("--worlds", type=Path, default=None,
                    help="directory of rendered worlds (tools/path_seeds.py)")
    args = ap.parse_args()
    kernels = [k for k in KERNELS if k in args.kernels.split(",")]
    if not torch.cuda.is_available():
        print("match_ab: no CUDA device", file=sys.stderr)
        return 1
    variants = {}
    for spec in args.csrc:
        name, d = spec.split("=", 1)
        variants[name] = Path(d).resolve()
    built = {name: build(name, d, kernels) for name, d in variants.items()}
    for name, (_, log) in built.items():
        for line in register_lines(name, log):
            print(line, flush=True)

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    from ..ops.camera import Camera

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
    rec = record(args, kernels, dev, cam, cs)
    for k in kernels:
        print("recorded " + describe(k, rec[k]), flush=True)
    twins, outs = twins_and_outputs(rec, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    jobs = {}
    for name, d in variants.items():
        calls = launchers(name, built[name][0], d, kernels)
        for k in kernels:
            jobs[(name, k)] = [(lambda a=a, o=o, f=calls[k]: f(a, o, stream))
                               for a, o in zip(rec[k], outs[k])]
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(max(len(c) for c in rec.values()))]

    results = {}
    for (name, k), calls in jobs.items():
        replay(calls, evs)  # warm-up, and the outputs compared below
        results[(name, k)] = dict(agreement(k, outs[k], twins[k]), rounds_ms=[])
    names = list(variants)
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            for k in kernels:
                results[(name, k)]["rounds_ms"].append(
                    replay(jobs[(name, k)], evs[:len(jobs[(name, k)])]))
    for (name, k), res in results.items():
        n = len(jobs[(name, k)])
        med = float(np.median(res["rounds_ms"]))
        print("match_ab " + json.dumps(dict(build=name, kernel=k.upper(), calls=n, median_ms=med,
                                            us_per_call=1e3 * med / n, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
