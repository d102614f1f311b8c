"""A/B device time of kernels K1 (the image stack), K3 (motion-only BA),
K4 (structure BA) and K6 (flash attention) built from several source
trees, on chip_smoke.py's inputs.

Run from the repository root on one CUDA card:

    python3 -m racing_slam_tpu_torch.tools.kernel_ab --csrc NAME=DIR [--csrc NAME=DIR ...]
        [--kernels k1,k3,k4,k6]

Each DIR holds the sources of the ``--kernels`` asked for
(``frontend_kernel.cu``, ``motion_ba_kernel.cu``,
``structure_ba_kernel.cu``, ``attention_kernel.cu``) and the headers they
include; each tree's sources are built by their own nvcc processes (all
started together, the flags of ``ops/kernels/_build.py``) and linked into
``build/kernel_ab/NAME.so``. A tree's C interface is told apart by its
symbols: the one-block K4 and single-launch K6 of the first port take no
cluster size and no workspace, a K4 that solves C problems a launch exports
`slam_structure_ba_max_clusters`, a K6 that runs S problems a call
`slam_flash_mha_seq`, and one whose CTAs may run every chunk of a tile and
merge them (fold) takes `fold` after `chunks` in its source's signature;
K1's and K3's interfaces are the same in every tree. Variants: K1 at each
``--k1-batch`` B (B = 1: the bench's masked frame, as ``check_frontend``
times it; B > 1: B frames unmasked, as ``check_frontend_batched``, and the
same frames as B single launches back to back); K3 at each ``--k3-seqs`` S
(and S > 1 as S single launches); K4 at each ``--k4-cluster`` size
(cluster trees) over each ``--k4-problems`` count C (trees that batch; the
first port's K4 runs C = 1 only), K6 at each ``--k6-chunks`` split (0 =
the wrapper's default; split trees) over each ``--k6-seqs`` count S (trees
that fold: at each ``--k6-fold`` choice, ``plan`` = the wrapper's
`launch_plan`, 0 = one chunk a CTA and the combine, 1 = every chunk of a
tile in one CTA), and torch's scaled_dot_product_attention in bf16 on the
same inputs as the yardstick. Inputs: K1 on the multi path's frames (frame
1 of each of the eight 98-frame bench worlds of
``chip_smoke.MULTI_SEEDS``, rendered by worker processes while the trees
build; B = 1 takes seed 3's), K3 on ``chip_smoke._k3_data`` with seeds 11,
12, ... (``check_motion_ba`` and ``check_motion_ba_batched``: K = 2400,
the tolerance exit on), K4 at the commit shape (``chip_smoke._k4_data``
with seeds 13, 14, ... and free cameras 31, 30, 29, 28, ..., as
``check_structure_ba_batched``: 2432 points x 8, F = 32, the exit on as
the main path runs it), K6 at [2400, 4, 32] with 80 % of the keys valid
(check_attention's first case) at S = 1, and with
``chip_smoke.K6_BATCHED_VALID``'s shares at S > 1
(check_attention_batched's rows). Every variant is timed with
``chip_smoke.cuda_ms`` (CUDA events around 25 back-to-back calls) in
rounds ordered A B ... B A (``--rounds`` times), so all see the same
clocks. Prints one JSON line per variant: the median and every round's ms
per call, the largest difference from the twin, for K1 and K3 at B, S > 1
whether every frame or row equals its single launch to the bit, and with
``--profile`` each kernel's device time a call under torch.profiler;
before that, each build's registers, shared memory and spills per kernel
(ptxas -v), how many K3 and K4 clusters the card holds at once, and
how many pixels of each tree's K1 maps differ from the first tree's (its
arithmetic is the same in every tree).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.ba import FUNCTION_TOLERANCE

REPO = Path(__file__).resolve().parents[2]
SOURCES = {"k1": "frontend_kernel.cu", "k3": "motion_ba_kernel.cu",
           "k4": "structure_ba_kernel.cu", "k6": "attention_kernel.cu"}


def build(name: str, csrc: Path, kernels=("k4", "k6")) -> tuple[Path, str]:
    """Compile and link one tree's sources of `kernels`; (library path,
    ptxas log)."""
    from ..ops.kernels import _build

    out_dir = REPO / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    sources = [SOURCES[k] for k in kernels]
    objs = [out_dir / f"{name}.{Path(src).stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc), "-c",
                               "-o", str(obj), str(csrc / src)],
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


def patched_tree(name: str, csrc: Path, source: str, patches: list, reader: str) -> Path:
    """build/NAME/csrc: a copy of the tree `csrc` whose `source` has each
    (text, replacement) of `patches` applied (each text must occur once)
    and `reader` appended: the probed copies of the *_phases tools."""
    out = REPO / "build" / name / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    src = (out / source).read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {source} no longer has {old!r} once")
        src = src.replace(old, new)
    (out / source).write_text(src + reader)
    return out


def ptxas_usage(log: str) -> list[str]:
    """One line per kernel of a `-Xptxas -v` log: name, registers, smem, spills."""
    rows = []
    for entry in log.split("Compiling entry function")[1:]:
        name = entry.split("'")[1]
        usage = [ln.split(":", 1)[-1].strip() for ln in entry.splitlines()
                 if "registers" in ln or "spill" in ln]
        rows.append(f"{name[:60]}: {'; '.join(usage)}")
    return rows


def k1_caller(lib):
    """fn(img [B, H, W], mask [H, W] | None) -> (resp, peaks, blur2) for
    one build of K1."""
    from ..ops.image import gaussian_kernel1d

    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = lib.slam_frontend
    fn.argtypes = [P_, P_, P_, P_, P_, I_, I_, I_, P_, I_, P_, I_, I_, P_]
    fn.restype = ctypes.c_int
    k1 = gaussian_kernel1d(1.2).astype(np.float32)
    k2 = gaussian_kernel1d(2.0).astype(np.float32)

    def call(img, mask):
        B, H, W = img.shape
        maps = [torch.empty_like(img) for _ in range(3)]
        err = fn(img.data_ptr(), None if mask is None else mask.data_ptr(),
                 *[m.data_ptr() for m in maps], B, H, W, k1.ctypes.data, 4, k2.ctypes.data, 6,
                 8, torch.cuda.current_stream(img.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err}")
        return maps

    return call


def k3_caller(lib):
    """fn(args [S, ...], kw) -> out [S, 8] for one build of K3."""
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.slam_motion_ba
    fn.argtypes = [P_] * 5 + [I_, I_] + [F_] * 6 + [I_, P_]
    fn.restype = ctypes.c_int

    def call(args, kw):
        pose0, kp_uv, xyz, valid = args
        S, K = kp_uv.shape[:2]
        out = torch.empty((S, 8), dtype=torch.float32, device=pose0.device)
        err = fn(*[t.data_ptr() for t in (pose0, kp_uv, xyz, valid, out)], S, K, kw["fx"],
                 kw["cx"], kw["cy"], 1e-4, kw["huber_delta"], FUNCTION_TOLERANCE,
                 kw["max_iters"], torch.cuda.current_stream(pose0.device).cuda_stream)
        if err:
            raise RuntimeError(f"K3 launch failed: CUDA error {err}")
        return out

    return call


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


def k1_variants(name: str, lib, frames, mask, ref) -> dict:
    """K1's variants of one build: B = 1 on frames[0] with `mask`, and
    for each larger B the batched launch and B single launches."""
    call = k1_caller(lib)
    out = {}
    for B in frames:
        img = frames[B]
        if B == 1:
            out[f"{name}/K1/B1"] = (lambda img=img: call(img, mask),
                                    lambda got: dict(max_abs_diff_from_twin=max(
                                        float((g - w).abs().max()) for g, w in
                                        zip(got[::2], ref[1][::2]))))
            continue
        singles = lambda img=img: [call(img[i:i + 1], None) for i in range(len(img))]  # noqa
        out[f"{name}/K1/B{B}"] = (
            lambda img=img: call(img, None),
            lambda got, singles=singles, B=B: dict(
                max_abs_diff_from_twin=max(float((g - w).abs().max())
                                           for g, w in zip(got[::2], ref[B][::2])),
                bit_equal_to_single=all(torch.equal(g[i], x[0]) for i, one in
                                        enumerate(singles()) for g, x in zip(got, one))))
        out[f"{name}/K1/{B}x_single"] = (singles, lambda got: {})
    return out


def k3_variants(name: str, lib, k3_in: dict, kw: dict, ref: dict) -> dict:
    """K3's variants of one build: each S in one launch, and S > 1 as S
    single launches."""
    call = k3_caller(lib)
    out = {}
    for S, args in k3_in.items():
        rows = [[a[i:i + 1] for a in args] for i in range(S)]
        out[f"{name}/K3/S{S}"] = (
            lambda args=args: call(args, kw),
            lambda got, S=S, rows=rows: dict(
                max_abs_diff_from_twin=float((got[:, :6] - ref[S][:, :6]).abs().max()),
                iterations=got[:, 7].int().tolist(),
                bit_equal_to_single=all(torch.equal(got[i], call(r, kw)[0])
                                        for i, r in enumerate(rows))))
        if S > 1:
            out[f"{name}/K3/{S}x_single"] = (lambda rows=rows: [call(r, kw) for r in rows],
                                             lambda got: {})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", required=True, help="NAME=DIR")
    ap.add_argument("--kernels", default="k1,k3,k4,k6", help="any of k1,k3,k4,k6")
    ap.add_argument("--k1-batch", default="1,8", help="frames a launch, at most 8")
    ap.add_argument("--k3-seqs", default="1,8", help="solves a launch, e.g. 1,8")
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

    from ..ops.camera import Camera
    from ..ops.kernels import attention, frontend, motion_ba, structure_ba
    from .scaling import render_worlds

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    ints = lambda text: [int(x) for x in text.split(",")]  # noqa: E731
    kernels = args.kernels.split(",")

    if "k1" in kernels:  # the multi path's frames, rendered while the trees build
        cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
        pool, pending = render_worlds(cam, [(s, cs.MULTI_FRAMES) for s in
                                            cs.MULTI_SEEDS[:max(ints(args.k1_batch))]])
    libs = {}
    for spec in args.csrc:
        name, d = spec.split("=", 1)
        so, log = build(name, Path(d).resolve(), kernels)
        for row in ptxas_usage(log):
            print(f"{name} {row}", flush=True)
        libs[name] = (ctypes.CDLL(str(so)), Path(d).resolve())

    variants = {}  # name -> (fn, fields of the row from fn's output)
    if "k1" in kernels:
        rendered = np.stack([w[0][1] for w in pending.get()]).astype(np.float32) / 255.0
        pool.close()
        pool.join()
        k1_in = {B: torch.from_numpy(rendered[:B]).to(dev) for B in ints(args.k1_batch)}
        mask = torch.from_numpy(cs._frontend_mask(480, 640)).to(dev)
        k1_ref = {B: frontend.corner_frontend_fused_reference(img, mask if B == 1 else None)
                  for B, img in k1_in.items()}
        maps = {}
        for name, (lib, _) in libs.items():
            variants.update(k1_variants(name, lib, k1_in, mask, k1_ref))
            maps[name] = [k1_caller(lib)(k1_in[B], mask if B == 1 else None) for B in k1_in]
        first, ref_name = next(iter(maps.values())), next(iter(maps))
        for name, m in maps.items():
            for j, B in enumerate(k1_in):
                diff = [int((a != b).sum()) for a, b in zip(first[j], m[j])]
                print(f"K1 B={B} {name} against {ref_name}: pixels that differ in the response, "
                      f"peaks, blur: {diff}", flush=True)
    if "k3" in kernels:
        k3_data = [cs._k3_data(np.random.default_rng(11 + i), dev)
                   for i in range(max(ints(args.k3_seqs)))]
        k3_kw = k3_data[0][1]
        k3_in = {S: [torch.stack([d[0][j] for d in k3_data[:S]]) for j in range(4)]
                 for S in ints(args.k3_seqs)}
        k3_ref = {S: motion_ba.motion_ba_lm_reference(*a, **k3_kw) for S, a in k3_in.items()}
        for name, (lib, _) in libs.items():
            if hasattr(lib, "slam_motion_ba_max_clusters"):
                lib.slam_motion_ba_max_clusters.argtypes = [ctypes.c_int]
                print(f"{name} K3: {lib.slam_motion_ba_max_clusters(2400)} clusters "
                      "co-resident", flush=True)
            variants.update(k3_variants(name, lib, k3_in, k3_kw, k3_ref))
    if "k4" in kernels:
        k4_data = [cs._k4_data(dev, seed=13 + i, free=31 - i % 4) for i in range(max(ints(
            args.k4_problems)))]
        k4_kw = k4_data[0][1]
        k4_in = {C: [torch.stack([d[0][j] for d in k4_data[:C]]) for j in range(8)]
                 for C in ints(args.k4_problems)}
        k4_ref = {C: structure_ba.structure_ba_lm_reference(*a, **k4_kw)[0]
                  for C, a in k4_in.items()}
        for name, (lib, _) in libs.items():
            has_cluster = hasattr(lib, "slam_structure_ba_scratch_bytes")
            batches = hasattr(lib, "slam_structure_ba_max_clusters")
            for c in (ints(args.k4_cluster) if has_cluster else [None]):
                if batches:
                    lib.slam_structure_ba_max_clusters.argtypes = [ctypes.c_int] * 3
                    print(f"{name} K4 cluster {c}: "
                          f"{lib.slam_structure_ba_max_clusters(2432, 8, c)} clusters co-resident",
                          flush=True)
                call = k4_caller(lib, c)
                for C in (ints(args.k4_problems) if batches else [1]):
                    variants[f"{name}/K4" + (f"/cluster{c}" if c else "") + f"/C{C}"] = (
                        lambda call=call, C=C: call(k4_in[C], k4_kw),
                        lambda out, C=C: dict(max_abs_diff_from_twin=float(
                            (out[0][:, :6] - k4_ref[C][..., :6]).abs().max())))
    if "k6" in kernels:
        k6_in = {}
        for S in ints(args.k6_seqs):
            rng = np.random.default_rng(9 if S == 1 else 19)
            shares = (0.8,) if S == 1 else (cs.K6_BATCHED_VALID * S)[:S]
            q, k, v = [torch.from_numpy(rng.normal(size=(S, 2400, 4, 32)).astype(np.float32))
                       .to(dev) for _ in range(3)]
            mask = torch.from_numpy(np.stack([rng.random(2400) < f for f in shares])).to(dev)
            k6_in[S] = (q, k, v, mask) if S > 1 else (q[0], k[0], v[0], mask[0])
        k6_ref = {S: attention.flash_mha_reference(*x) for S, x in k6_in.items()}
        for name, (lib, d) in libs.items():
            interface = k6_interface(lib, d)
            for S in (ints(args.k6_seqs) if interface in ("seq", "fold") else [1]):
                for n in (ints(args.k6_chunks) if interface != "single" else [0]):
                    for f in (args.k6_fold.split(",") if interface == "fold" else ["plan"]):
                        call = k6_caller(lib, interface, n, None if f == "plan" else f == "1")
                        key = (f"{name}/K6/S{S}" + (f"/chunks{n or 'default'}"
                                                     if interface != "single" else "")
                               + (f"/fold{f}" if interface == "fold" else ""))
                        variants[key] = (lambda call=call, S=S: call(*k6_in[S]),
                                         lambda out, S=S: dict(max_abs_diff_from_twin=float(
                                             (out - k6_ref[S]).abs().max())))
        for S, (q, k, v, mask) in k6_in.items():
            lead = q.dim() == 4
            qb, kb, vb = [(x if lead else x[None]).to(torch.bfloat16).permute(0, 2, 1, 3)
                          for x in (q, k, v)]
            add = torch.where(mask if lead else mask[None], 0.0, -1e9).to(torch.bfloat16)
            add = add[:, None, None, :]
            variants[f"sdpa_bf16/S{S}"] = (
                lambda qb=qb, kb=kb, vb=vb, add=add:
                    torch.nn.functional.scaled_dot_product_attention(qb, kb, vb, attn_mask=add),
                lambda out, S=S, lead=lead: dict(max_abs_diff_from_twin=float(
                    (out.permute(0, 2, 1, 3).float()[slice(None) if lead else 0] - k6_ref[S])
                    .abs().max())))

    fields = {key: check(fn()) for key, (fn, check) in variants.items()}
    torch.cuda.synchronize()
    order = list(variants)
    times = {key: [] for key in order}
    for r in range(args.rounds):
        for key in (order if r % 2 == 0 else order[::-1]):
            times[key].append(cs.cuda_ms(variants[key][0]))
    for key in order:
        row = dict(variant=key, ms=float(np.median(times[key])),
                   rounds=[round(t, 5) for t in times[key]], **fields[key])
        if args.profile:
            row["kernels_us"] = profile_kernels(variants[key][0])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
