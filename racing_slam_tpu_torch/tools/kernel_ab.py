"""A/B device time of kernels K4 (structure BA) and K6 (flash attention)
built from several source trees, on chip_smoke.py's inputs.

Run from the repository root on one CUDA card:

    python3 -m racing_slam_tpu_torch.tools.kernel_ab --csrc NAME=DIR [--csrc NAME=DIR ...]

Each DIR holds ``structure_ba_kernel.cu``, ``attention_kernel.cu`` and the
headers they include; each tree's two sources are built by their own nvcc
processes (all started together, the flags of ``ops/kernels/_build.py``)
and linked into ``build/kernel_ab/NAME.so``. A tree's C interface is told
apart by its symbols: the one-block K4 and single-launch K6 of the first
port take no cluster size and no workspace, a K4 that solves C problems a
launch exports `slam_structure_ba_max_clusters`, a K6 that runs S problems
a call `slam_flash_mha_seq`, and one whose CTAs may run every chunk of a
tile and merge them (fold) takes `fold` after `chunks` in its source's
signature. Variants: K4 at each
``--k4-cluster`` size (cluster trees) over each ``--k4-problems`` count C
(trees that batch; the first port's K4 runs C = 1 only), K6 at each
``--k6-chunks`` split (0 = the wrapper's default; split trees) over each
``--k6-seqs`` count S (trees that fold: at each ``--k6-fold`` choice,
``plan`` = the wrapper's `launch_plan`, 0 = one chunk a CTA and the
combine, 1 = every chunk of a tile in one CTA), and torch's scaled_dot_product_attention in bf16 on the same inputs as the
yardstick. Inputs: K4 at the commit shape (``chip_smoke._k4_data`` with
seeds 13, 14, ... and free cameras 31, 30, 29, 28, ..., as
``check_structure_ba_batched``: 2432 points x 8, F = 32, the exit on as
the main path runs it), K6 at [2400, 4, 32] with 80 % of the keys valid
(check_attention's first case) at S = 1, and with
``chip_smoke.K6_BATCHED_VALID``'s shares at S > 1 (check_attention_batched's
rows). Every variant is timed with ``chip_smoke.cuda_ms`` (CUDA events
around 25 back-to-back calls) in rounds ordered A B ... B A (``--rounds``
times), so all see the same clocks. Prints one JSON line per variant: the
median and every round's ms per call, the largest difference from the
twin, and with ``--profile`` each kernel's device time a call under
torch.profiler; before that, each build's registers, shared memory and
spills per kernel (ptxas -v), and how many K4 clusters of each size the
card holds at once.
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

from ..ops.ba import FUNCTION_TOLERANCE

REPO = Path(__file__).resolve().parents[2]
SOURCES = ("structure_ba_kernel.cu", "attention_kernel.cu")


def build(name: str, csrc: Path) -> tuple[Path, str]:
    """Compile and link one tree; (library path, ptxas log)."""
    from ..ops.kernels import _build

    out_dir = REPO / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    objs = [out_dir / f"{name}.{Path(src).stem}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc), "-c",
                               "-o", str(obj), str(csrc / src)],
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


def ptxas_usage(log: str) -> list[str]:
    """One line per kernel of a `-Xptxas -v` log: name, registers, smem, spills."""
    rows = []
    for entry in log.split("Compiling entry function")[1:]:
        name = entry.split("'")[1]
        usage = [ln.split(":", 1)[-1].strip() for ln in entry.splitlines()
                 if "registers" in ln or "spill" in ln]
        rows.append(f"{name[:60]}: {'; '.join(usage)}")
    return rows


def k4_caller(lib, cluster: int | None):
    """fn(args, kw) -> (out, points) for one build of K4; args may carry a
    leading C (trees that batch)."""
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.slam_structure_ba
    fn.restype = ctypes.c_int
    batches = hasattr(lib, "slam_structure_ba_max_clusters")  # C problems a launch
    if cluster is None:
        fn.argtypes = [P_] * 11 + [I_, I_, I_, F_, F_, F_, F_, F_, F_, I_, P_]
    else:
        fn.argtypes = [P_] * 11 + [I_] * (3 + batches) + [F_] * 6 + [I_, I_, P_]
        lib.slam_structure_ba_scratch_bytes.argtypes = [I_, I_, I_]
        lib.slam_structure_ba_scratch_bytes.restype = ctypes.c_size_t

    def call(args, kw):
        cam_rvec, cam_t, points, obs_cam, obs_uv, include, point_free, free_slot = args
        C = free_slot.numel()
        F, (P, O) = cam_rvec.shape[-2], obs_cam.shape[-2:]
        dev = points.device
        out = torch.empty((C, 8), dtype=torch.float32, device=dev)
        pts = torch.empty((C, P, 3), dtype=torch.float32, device=dev)
        if cluster is None:
            scratch = torch.empty(P * 33, dtype=torch.float32, device=dev)
            tail = []
        else:
            n = C * lib.slam_structure_ba_scratch_bytes(P, O, cluster)
            scratch = torch.empty(n // 4, dtype=torch.float32, device=dev) if n else None
            tail = [cluster]
        err = fn(*[t.data_ptr() if t is not None else None for t in (
            cam_rvec, cam_t, free_slot, points, obs_cam, obs_uv, include, point_free, out, pts,
            scratch)], *([C] if batches else []), F, P, O, kw["fx"], kw["cx"], kw["cy"], 1e-4,
            kw["huber_delta"], FUNCTION_TOLERANCE, kw["max_iters"], *tail,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"K4 launch failed: CUDA error {err}")
        return out, pts

    return call


def k6_interface(lib, csrc: Path) -> str:
    """Which C interface a build of K6 from the tree `csrc` exports: "fold"
    (S problems a call, CTAs that may fold), "seq" (S problems a call),
    "split" (one problem, with a workspace) or "single" (one launch, no
    workspace)."""
    if hasattr(lib, "slam_flash_mha_seq"):
        src = (csrc / "attention_kernel.cu").read_text()
        return "fold" if "int chunks, int fold," in src else "seq"
    return "split" if hasattr(lib, "slam_flash_mha_workspace_bytes") else "single"


def k6_caller(lib, interface: str, chunks: int, fold: bool | None = None):
    """fn(q, k, v, mask) -> out for one build of K6 (`interface` from
    k6_interface); q, k, v, mask may carry a leading S ("seq" and "fold").
    `fold` ("fold" trees): whether the CTAs fold, None = `launch_plan`'s."""
    from ..ops.kernels import attention

    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.slam_flash_mha if interface in ("single", "split") else lib.slam_flash_mha_seq
    fn.restype = ctypes.c_int
    n_int = {"single": 4, "split": 5, "seq": 6, "fold": 6}[interface]
    if interface == "single":
        fn.argtypes = [P_] * 5 + [I_] * 4 + [F_, P_]
    else:
        ws_bytes = (lib.slam_flash_mha_workspace_bytes if interface == "split"
                    else lib.slam_flash_mha_seq_workspace_bytes)
        fn.argtypes = [P_] * 6 + [I_] * (n_int + (interface == "fold")) + [F_, P_]
        ws_bytes.argtypes = [I_] * n_int
        ws_bytes.restype = ctypes.c_size_t

    def call(q, k, v, mask):
        S = q.shape[0] if q.dim() == 4 else 1
        Kq, H, dh = q.shape[-3:]
        Kk = k.shape[-3]
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scale = 1.0 / float(dh) ** 0.5
        ptrs = [t.data_ptr() for t in (q, k, v, mask, out)]
        if interface == "single":
            err = fn(*ptrs, Kq, Kk, H, dh, scale, stream)
        else:
            n = chunks or attention.default_chunks(Kq, Kk, H)
            sizes = [Kq, Kk, H, dh, n]
            if interface != "split":
                sizes = [S, *sizes]
            ws = torch.empty(ws_bytes(*sizes), dtype=torch.uint8, device=q.device)
            if interface == "fold":
                f = attention.launch_plan(S, Kq, Kk, H, n).fold if fold is None else fold
                err = fn(*ptrs, ws.data_ptr(), *sizes, int(f), scale, stream)
            else:
                err = fn(*ptrs, ws.data_ptr(), *sizes, scale, stream)
        if err:
            raise RuntimeError(f"K6 launch failed: CUDA error {err}")
        return out

    return call


def profile_kernels(fn, n: int = 20) -> dict:
    """Device microseconds a call of each kernel fn() launches, over n calls
    under torch.profiler."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if t > 0:
            name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            rows[name.split("(")[0][:48]] = round(t / n, 3)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", required=True, help="NAME=DIR")
    ap.add_argument("--k4-cluster", default="16", help="cluster sizes, e.g. 8,16")
    ap.add_argument("--k4-problems", default="1", help="problems a launch, e.g. 1,8")
    ap.add_argument("--k6-chunks", default="0", help="key splits, 0 = the default")
    ap.add_argument("--k6-seqs", default="1", help="problems a call, e.g. 1,8")
    ap.add_argument("--k6-fold", default="plan", help="plan, 0 and / or 1, e.g. 0,1")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--profile", action="store_true", help="each kernel's device time a call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    from ..ops.kernels import attention, structure_ba

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    ints = lambda text: [int(x) for x in text.split(",")]  # noqa: E731

    k4_data = [cs._k4_data(dev, seed=13 + i, free=31 - i % 4) for i in range(max(ints(
        args.k4_problems)))]
    k4_kw = k4_data[0][1]
    k4_in = {C: [torch.stack([d[0][j] for d in k4_data[:C]]) for j in range(8)]
             for C in ints(args.k4_problems)}
    k4_ref = {C: structure_ba.structure_ba_lm_reference(*a, **k4_kw)[0] for C, a in k4_in.items()}
    k6_in = {}
    for S in ints(args.k6_seqs):
        rng = np.random.default_rng(9 if S == 1 else 19)
        shares = (0.8,) if S == 1 else (cs.K6_BATCHED_VALID * S)[:S]
        q, k, v = [torch.from_numpy(rng.normal(size=(S, 2400, 4, 32)).astype(np.float32)).to(dev)
                   for _ in range(3)]
        mask = torch.from_numpy(np.stack([rng.random(2400) < f for f in shares])).to(dev)
        k6_in[S] = (q, k, v, mask) if S > 1 else (q[0], k[0], v[0], mask[0])
    k6_ref = {S: attention.flash_mha_reference(*x) for S, x in k6_in.items()}

    variants = {}  # name -> (fn, twin check)
    for spec in args.csrc:
        name, d = spec.split("=", 1)
        so, log = build(name, Path(d).resolve())
        for row in ptxas_usage(log):
            print(f"{name} {row}", flush=True)
        lib = ctypes.CDLL(str(so))
        has_cluster = hasattr(lib, "slam_structure_ba_scratch_bytes")
        batches = hasattr(lib, "slam_structure_ba_max_clusters")
        for c in (ints(args.k4_cluster) if has_cluster else [None]):
            if batches:
                lib.slam_structure_ba_max_clusters.argtypes = [ctypes.c_int] * 3
                print(f"{name} K4 cluster {c}: {lib.slam_structure_ba_max_clusters(2432, 8, c)} "
                      "clusters co-resident", flush=True)
            call = k4_caller(lib, c)
            for C in (ints(args.k4_problems) if batches else [1]):
                variants[f"{name}/K4" + (f"/cluster{c}" if c else "") + f"/C{C}"] = (
                    lambda call=call, C=C: call(k4_in[C], k4_kw),
                    lambda out, C=C: float((out[0][:, :6] - k4_ref[C][..., :6]).abs().max()))
        interface = k6_interface(lib, Path(d).resolve())
        for S in (ints(args.k6_seqs) if interface in ("seq", "fold") else [1]):
            for n in (ints(args.k6_chunks) if interface != "single" else [0]):
                for f in (args.k6_fold.split(",") if interface == "fold" else ["plan"]):
                    call = k6_caller(lib, interface, n, None if f == "plan" else f == "1")
                    key = (f"{name}/K6/S{S}" + (f"/chunks{n or 'default'}"
                                                 if interface != "single" else "")
                           + (f"/fold{f}" if interface == "fold" else ""))
                    variants[key] = (lambda call=call, S=S: call(*k6_in[S]),
                                     lambda out, S=S: float((out - k6_ref[S]).abs().max()))
    for S, (q, k, v, mask) in k6_in.items():
        lead = q.dim() == 4
        qb, kb, vb = [(x if lead else x[None]).to(torch.bfloat16).permute(0, 2, 1, 3)
                      for x in (q, k, v)]
        add = torch.where(mask if lead else mask[None], 0.0, -1e9).to(torch.bfloat16)
        add = add[:, None, None, :]
        variants[f"sdpa_bf16/S{S}"] = (
            lambda qb=qb, kb=kb, vb=vb, add=add: torch.nn.functional.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=add),
            lambda out, S=S, lead=lead: float(
                (out.permute(0, 2, 1, 3).float()[slice(None) if lead else 0] - k6_ref[S])
                .abs().max()))

    errs = {}
    for key, (fn, err) in variants.items():
        errs[key] = err(fn())
    torch.cuda.synchronize()
    order = list(variants)
    times = {key: [] for key in order}
    for r in range(args.rounds):
        for key in (order if r % 2 == 0 else order[::-1]):
            times[key].append(cs.cuda_ms(variants[key][0]))
    for key in order:
        row = dict(variant=key, ms=float(np.median(times[key])),
                   rounds=[round(t, 5) for t in times[key]], max_abs_diff_from_twin=errs[key])
        if args.profile:
            row["kernels_us"] = profile_kernels(variants[key][0])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
