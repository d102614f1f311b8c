"""ATE, coverage and re-initialisations of one ``chip_smoke.py`` path on
several seeds' bench worlds, from the checkout it is run in.

Run from the root of a checkout on one CUDA card:

    python3 -m racing_slam_tpu_torch.tools.path_seeds --path learned --seeds 3,7,9 \\
        [--worlds build/worlds]

Each run is ``chip_smoke.run_path`` (the path's configuration, launch
counts and one host read a tracked frame asserted) on one seed's world;
each prints one line ``path_seeds {json}``. The kernels are built first, as
``chip_smoke.py`` builds them. ``--worlds DIR`` keeps the rendered worlds
as .npz files, rendering the missing ones in parallel processes: a world
depends on its seed and length alone, so another checkout can be run on
the same frames. To run another checkout (an older commit unpacked under
``build/``, say), run this file from that checkout's root with
``PYTHONPATH=.``: it imports ``chip_smoke`` and the port from the
directory it is run in.

``--bootstrap DIR`` runs each seed from the bootstrapped state the JAX
package exported for it (``DIR/jax_boot_seed<S>.npz``, written by
``tests/learned_reference.py --export DIR``) instead of the port's own:
the port bootstraps as usual (so its frame counters advance the same way,
asserted), then tracks from the JAX package's state. The two packages draw
their two-view RANSAC hypotheses from different generators by design; this
takes that draw out of a comparison of their trajectories.

``--slam-seeds 0,1,...`` runs each world once for each seed of the
port's own bootstrap generator (``Slam(seed=...)``, 0 by default): the
spread of the readings over the two-view RANSAC draw alone.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np


def _camera():
    from racing_slam_tpu_torch.ops.camera import Camera

    return Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)


def _render(seed: int, n_frames: int, out: str) -> float:
    """Render one world into `out` (.npz of frames and poses); seconds taken."""
    import chip_smoke as cs

    t0 = time.time()
    frames, poses = cs.render_bench_world(seed, _camera(), n_frames)
    np.savez(out, frames=np.stack(frames), poses=poses)
    return time.time() - t0


def worlds(seeds: list, n_frames: int, cache: Path | None) -> dict:
    """{seed: (frames, poses)}, from `cache` where it holds them."""
    import chip_smoke as cs

    if cache is None:
        return {s: cs.render_bench_world(s, _camera(), n_frames) for s in seeds}
    cache.mkdir(parents=True, exist_ok=True)
    files = {s: cache / f"seed{s}_{n_frames}.npz" for s in seeds}
    missing = [s for s in seeds if not files[s].exists()]
    if missing:  # before any CUDA call: the workers are forked
        with ProcessPoolExecutor(len(missing), mp_context=multiprocessing.get_context("fork")) as ex:
            for s, sec in zip(missing, ex.map(_render, missing, [n_frames] * len(missing),
                                              [str(files[s]) for s in missing])):
                print(f"rendered {n_frames} frames of seed {s} in {sec:.1f} s", flush=True)
    out = {}
    for s in seeds:
        with np.load(files[s]) as z:
            out[s] = (list(z["frames"]), z["poses"])
    return out


def jax_bootstrap(path: Path):
    """The exported JAX SlamState (dotted leaf names) as nested namespaces,
    which utils.convert.state_from_numpy takes."""
    from types import SimpleNamespace

    root: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = root
            *parents, leaf = key.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]

    def ns(d):
        return SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v for k, v in d.items()})

    return ns(root)


def tracking_from(state):
    """Within the block, Slam.initialize() bootstraps and then replaces the
    state by `state` (a JAX SlamState with numpy leaves)."""
    import contextlib

    from racing_slam_tpu_torch.slam.pipeline import Slam
    from racing_slam_tpu_torch.utils.convert import state_from_numpy

    own = Slam.initialize

    def initialize(self):
        ok = own(self)
        frames = int(self.state.frame_count)
        self.state = state_from_numpy(state, device=self.device)
        assert int(self.state.frame_count) == frames, "bootstraps ended at different frames"
        return ok

    @contextlib.contextmanager
    def patched():
        Slam.initialize = initialize
        try:
            yield
        finally:
            Slam.initialize = own

    return patched()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="learned")
    ap.add_argument("--seeds", default="3")
    ap.add_argument("--worlds", type=Path, default=None, help="directory of rendered worlds")
    ap.add_argument("--bootstrap", type=Path, default=None,
                    help="directory of JAX bootstrapped states (tests/learned_reference.py)")
    ap.add_argument("--slam-seeds", default="0", help="seeds of the port's bootstrap generator")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())  # this checkout's chip_smoke and port

    import torch

    if not torch.cuda.is_available():
        print("path_seeds: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    seeds = [int(x) for x in args.seeds.split(",")]
    world = worlds(seeds, cs.PATHS[args.path][2], args.worlds)

    from racing_slam_tpu_torch.ops.kernels import (_build, attention, frontend, match,
                                                   match_banded, motion_ba, structure_ba)

    _build.build()
    _build.lib()
    dev = torch.device("cuda", 0)
    kernels = [dict(name=n, module=m) for n, m in [
        ("corner_frontend_fused", frontend), ("guided_match_stage1", match),
        ("motion_ba_lm", motion_ba), ("structure_ba_lm", structure_ba),
        ("guided_match_stage1_banded", match_banded), ("flash_mha", attention)]]
    keep = ("ate_pct", "coverage", "reinits", "eof_on_reinit", "commits", "keyframes",
            "tracked", "syncs_per_tracked_frame", "fps")
    for s in seeds:
        for g in [int(x) for x in args.slam_seeds.split(",")]:
            if args.bootstrap is None:
                res = cs.run_path(args.path, dev, kernels, _camera(), *world[s], slam_seed=g)
            else:
                with tracking_from(jax_bootstrap(args.bootstrap / f"jax_boot_seed{s}.npz")):
                    res = cs.run_path(args.path, dev, kernels, _camera(), *world[s], slam_seed=g)
            print("path_seeds " + json.dumps(dict(
                tree=os.path.basename(os.getcwd()), path=args.path, seed=s, slam_seed=g,
                bootstrap="port" if args.bootstrap is None else "jax",
                **{k: res[k] for k in keep})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
