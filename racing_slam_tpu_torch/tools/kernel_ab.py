"""A/B device time of kernels K4 (structure BA) and K6 (flash attention)
built from several source trees, on chip_smoke.py's inputs.

Run from the repository root on one CUDA card:

    python3 -m racing_slam_tpu_torch.tools.kernel_ab --csrc NAME=DIR [--csrc NAME=DIR ...]

Each DIR holds ``structure_ba_kernel.cu``, ``attention_kernel.cu`` and the
headers they include; each tree's two sources are built by their own nvcc
processes (all started together, the flags of ``ops/kernels/_build.py``)
and linked into ``build/kernel_ab/NAME.so``. A tree's C interface is told
apart by its symbols: the one-block K4 and single-launch K6 of the first
port take no cluster size and no workspace. Variants: K4 at each
``--k4-cluster`` size (cluster trees), K6 at each ``--k6-chunks`` split
(0 = the wrapper's default; split trees), and torch's scaled_dot_product_attention in bf16 on the same
inputs as the yardstick. Inputs: K4 at the commit shape
(``chip_smoke._k4_data``: 2432 points x 8, F = 32, the exit on as the
main path runs it), K6 at [2400, 4, 32] with 80 % of the keys valid
(check_attention's first case). Every variant is timed with
``chip_smoke.cuda_ms`` (CUDA events around 25 back-to-back calls) in
rounds ordered A B ... B A (``--rounds`` times), so all see the same
clocks. Prints one JSON line per variant: the median and every round's ms
per call, and the largest difference from the twin; before that, each
build's registers, shared memory and spills per kernel (ptxas -v).
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
    """fn(args, kw) -> (out, points) for one build of K4."""
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.slam_structure_ba
    fn.restype = ctypes.c_int
    if cluster is None:
        fn.argtypes = [P_] * 11 + [I_, I_, I_, F_, F_, F_, F_, F_, F_, I_, P_]
    else:
        fn.argtypes = [P_] * 11 + [I_, I_, I_, F_, F_, F_, F_, F_, F_, I_, I_, P_]
        lib.slam_structure_ba_scratch_bytes.argtypes = [I_, I_, I_]
        lib.slam_structure_ba_scratch_bytes.restype = ctypes.c_size_t

    def call(args, kw):
        cam_rvec, cam_t, points, obs_cam, obs_uv, include, point_free, free_slot = args
        F, (P, O) = cam_rvec.shape[0], obs_cam.shape
        dev = points.device
        out = torch.empty(8, dtype=torch.float32, device=dev)
        pts = torch.empty((P, 3), dtype=torch.float32, device=dev)
        if cluster is None:
            scratch = torch.empty(P * 33, dtype=torch.float32, device=dev)
            tail = []
        else:
            n = lib.slam_structure_ba_scratch_bytes(P, O, cluster)
            scratch = torch.empty(n // 4, dtype=torch.float32, device=dev) if n else None
            tail = [cluster]
        err = fn(*[t.data_ptr() if t is not None else None for t in (
            cam_rvec, cam_t, free_slot, points, obs_cam, obs_uv, include, point_free, out, pts,
            scratch)], F, P, O, kw["fx"], kw["cx"], kw["cy"], 1e-4, kw["huber_delta"],
            FUNCTION_TOLERANCE, kw["max_iters"], *tail, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"K4 launch failed: CUDA error {err}")
        return out, pts

    return call


def k6_caller(lib, split: bool, chunks: int):
    """fn(q, k, v, mask) -> out for one build of K6 (split False: the
    single-launch interface)."""
    from ..ops.kernels import attention

    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.slam_flash_mha
    fn.restype = ctypes.c_int
    if not split:
        fn.argtypes = [P_] * 5 + [I_] * 4 + [F_, P_]
    else:
        fn.argtypes = [P_] * 6 + [I_] * 5 + [F_, P_]
        lib.slam_flash_mha_workspace_bytes.argtypes = [I_] * 5
        lib.slam_flash_mha_workspace_bytes.restype = ctypes.c_size_t

    def call(q, k, v, mask):
        Kq, H, dh = q.shape
        Kk = k.shape[0]
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scale = 1.0 / float(dh) ** 0.5
        ptrs = [t.data_ptr() for t in (q, k, v, mask, out)]
        if not split:
            err = fn(*ptrs, Kq, Kk, H, dh, scale, stream)
        else:
            S = chunks or attention.default_chunks(Kq, Kk, H)
            ws = torch.empty(lib.slam_flash_mha_workspace_bytes(Kq, Kk, H, dh, S),
                             dtype=torch.uint8, device=q.device)
            err = fn(*ptrs, ws.data_ptr(), Kq, Kk, H, dh, S, scale, stream)
        if err:
            raise RuntimeError(f"K6 launch failed: CUDA error {err}")
        return out

    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", required=True, help="NAME=DIR")
    ap.add_argument("--k4-cluster", default="16", help="cluster sizes, e.g. 8,16")
    ap.add_argument("--k6-chunks", default="0", help="key splits, 0 = the default")
    ap.add_argument("--rounds", type=int, default=3)
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

    k4_args, k4_kw, _ = cs._k4_data(dev)
    rng = np.random.default_rng(9)
    q, k, v = [torch.from_numpy(rng.normal(size=(2400, 4, 32)).astype(np.float32)).to(dev)
               for _ in range(3)]
    mask = torch.from_numpy(rng.random(2400) < 0.8).to(dev)
    k4_ref = structure_ba.structure_ba_lm_reference(*k4_args, **k4_kw)[0]
    k6_ref = attention.flash_mha_reference(q, k, v, mask)

    variants = {}  # name -> (fn, twin check)
    for spec in args.csrc:
        name, d = spec.split("=", 1)
        so, log = build(name, Path(d).resolve())
        for row in ptxas_usage(log):
            print(f"{name} {row}", flush=True)
        lib = ctypes.CDLL(str(so))
        has_cluster = hasattr(lib, "slam_structure_ba_scratch_bytes")
        for c in ([int(x) for x in args.k4_cluster.split(",")] if has_cluster else [None]):
            call = k4_caller(lib, c)
            variants[f"{name}/K4" + (f"/cluster{c}" if c else "")] = (
                lambda call=call: call(k4_args, k4_kw),
                lambda out: float((out[0][:6] - k4_ref[:6]).abs().max()))
        has_ws = hasattr(lib, "slam_flash_mha_workspace_bytes")
        for S in ([int(x) for x in args.k6_chunks.split(",")] if has_ws else [0]):
            call = k6_caller(lib, has_ws, S)
            key = f"{name}/K6" + (f"/chunks{S or 'default'}" if has_ws else "")
            variants[key] = (lambda call=call: call(q, k, v, mask),
                             lambda out: float((out - k6_ref).abs().max()))
    qb, kb, vb = [x.to(torch.bfloat16).permute(1, 0, 2)[None] for x in (q, k, v)]
    add = torch.where(mask, 0.0, -1e9).to(torch.bfloat16)[None, None, None, :]
    variants["sdpa_bf16"] = (
        lambda: torch.nn.functional.scaled_dot_product_attention(qb, kb, vb, attn_mask=add),
        lambda out: float((out[0].permute(1, 0, 2).float() - k6_ref).abs().max()))

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
        print(json.dumps(dict(variant=key, ms=float(np.median(times[key])),
                              rounds=[round(t, 5) for t in times[key]],
                              max_abs_diff_from_twin=errs[key])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
