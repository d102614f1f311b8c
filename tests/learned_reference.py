"""The JAX package's learned path (or another chip_smoke.py path) on one
seed's bench world, on the CPU, as the reference of the port's ATE.

    env JAX_PLATFORMS=cpu python tests/learned_reference.py --seed 7 [--export DIR] \
        [--slam-seed 0] [--path learned]

The configuration is chip_smoke.py's learned path (bench.py --variant
learned --local-ba-window 1 --refine-every 0: SuperPoint on the committed
weights, LightGlue on lightglue_superpoint.npz), or with --path the
configuration of that chip_smoke.py path (`chip_smoke.path_config`; the
classical frontend unless the path is `learned`), the world the port's
renderer makes (chip_smoke.render_bench_world, the frames bench.py
renders). Prints one line ``learned_reference {json}`` with bench.py's
full-trajectory ATE, coverage and re-initialisations of the run from the
package's own bootstrap. With --export, the bootstrapped state is written
first to DIR/jax_boot_seed<S>.npz (the SlamState's leaves under their
dotted field names, bf16 as float32), from which
racing_slam_tpu_torch/tools/path_seeds.py --bootstrap DIR runs the port,
so that the two packages track from the same two-view bootstrap (their
RANSAC draws differ by design). --slam-seed seeds the package's own
generator (``Slam(seed=...)``, 0 as bench.py), which draws the RANSAC
hypotheses. Takes ~9 minutes and ~3 cores.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def flat_state(state) -> dict:
    """{dotted field name: numpy leaf} of a (nested) SlamState."""
    out = {}

    def walk(prefix, obj):
        for f in obj._fields:
            v = getattr(obj, f)
            if hasattr(v, "_fields"):
                walk(prefix + f + ".", v)
            else:
                a = np.asarray(v)
                out[prefix + f] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    walk("", state)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--export", type=Path, default=None)
    ap.add_argument("--slam-seed", type=int, default=0)
    ap.add_argument("--path", default="learned")
    args = ap.parse_args()

    import dataclasses

    import jax

    import bench
    import chip_smoke as cs
    from racing_slam_tpu.models import superpoint
    from racing_slam_tpu.ops.camera import Camera
    from racing_slam_tpu.slam.config import SlamConfig
    from racing_slam_tpu.slam.pipeline import Slam
    from racing_slam_tpu.utils.video import ArraySource

    t0 = time.time()
    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
    frames, gt = cs.render_bench_world(args.seed, cam, cs.PATHS[args.path][2])
    cfg = SlamConfig(**dataclasses.asdict(cs.path_config(args.path)))
    fe = None if cs.PATHS[args.path][0] != "superpoint" else superpoint.SuperPointFrontend(
        params=superpoint.load_params(REPO / "racing_slam_tpu" / "weights" / "superpoint.npz"))
    slam = Slam(cam, ArraySource(frames), cfg, frontend=fe, seed=args.slam_seed)
    assert slam.initialize(), "bootstrap failed"
    if args.export is not None:
        args.export.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.export / f"jax_boot_seed{args.seed}.npz",
                            **flat_state(jax.tree.map(np.asarray, slam.state)))
    slam.run_batched(batch=48)
    res = bench.full_trajectory_ate(slam, SimpleNamespace(poses=gt, frames=frames))
    print("learned_reference " + json.dumps(dict(
        path=args.path, seed=args.seed, slam_seed=args.slam_seed,
        ate_pct=100 * res["ate"] / res["length"], ate=res["ate"],
        length=res["length"], coverage=res["coverage"], reinits=slam.n_reinits,
        seconds=time.time() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
