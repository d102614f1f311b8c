"""Multi-sequence tracking in lockstep (port of racing_slam_tpu/parallel/multi_seq.py).

The deployment shape is a fleet: S independent sequences tracked at once,
each with its own SlamState, stacked on a leading axis and stepped in
lockstep by one batched step (slam.pipeline.slam_step_multi), so that the
S sequences share each kernel launch: K1 once and K2 and K3 twice a
lockstep frame, whatever S is, and K4 once for the rows that commit on
it. The JAX package `vmap`s its step over the sequence axis and shards
that axis over the mesh's 'seq' devices.

Over several processes (parallel.mesh.initialize_distributed), every rank
constructs MultiSlam with the videos of its own sequence rows; its rows
are the block of global rows of its 'seq' coordinate, and the ranks that
share it (its 'lm' peers) bring the same videos and track the same rows.
The ranks run `run_batched` in lockstep. Control decisions (how many
frames a batch takes, which sequences are lost) are made identically on
every rank from per-row host scalars gathered with `all_gather_object`;
pixel and state data never leave their rank. Rows are seeded per global
row, so a run over several ranks reproduces the single-process one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.camera import Camera
from ..slam.config import SlamConfig
from ..slam.pipeline import Slam, slam_step_multi
from ..slam.state import SlamState, set_state_row, stack_states, state_row, tree_map
from .mesh import axis_rank, axis_size


def batched_state(S: int, F: int, Pcap: int, O: int, K: int, D: int, A: int = 512,
                  device="cuda") -> SlamState:
    """A blank stacked SlamState for S sequences on `device` (the card
    unless told otherwise)."""
    one = SlamState.create(F=F, P=Pcap, O=O, K=K, D=D, A=A, device=device)
    return stack_states([one] * S, device=device)


def local_row_indices(mesh, S_global: int) -> list[int]:
    """Global sequence rows of this rank: the block of its 'seq'
    coordinate (all rows with no mesh or a single coordinate)."""
    n = axis_size(mesh, "seq")
    if S_global % n != 0:
        raise ValueError(f"{S_global} sequences not divisible by the 'seq' axis ({n})")
    per = S_global // n
    r = axis_rank(mesh, "seq")
    return list(range(r * per, (r + 1) * per))


def multi_sequence_step(*, cam: Camera, cfg: SlamConfig, frontend):
    """The lockstep step as a function of (states, imgs [S, H, W], active
    [S] host bools, mask, commit_nos, generators, uniforms, last_inliers)
    -> (states, MultiStepInfo), the counterpart of the JAX package's jitted
    batched step (slam.pipeline.slam_step_multi)."""

    def step(states, imgs, active, mask, commit_nos=None, generators=None, uniforms=None,
             last_inliers=None):
        return slam_step_multi(states, imgs, active, mask, cam=cam, cfg=cfg, frontend=frontend,
                               commit_nos=commit_nos, generators=generators, uniforms=uniforms,
                               last_inliers=last_inliers)

    return step


class MultiSlam:
    """Host driver for S sequences tracked in lockstep on one device a rank.

    Mirrors the single-sequence Slam but steps all sequences together.
    Initialisation runs per sequence on the single-sequence path (it is
    control-flow heavy and happens once), then the states are stacked.
    `videos` are this rank's sequences (all of them in a single process).
    With `refine_every > 0` a landmark-sharded full BA over every
    sequence's live map runs every `refine_every` batches
    (parallel/refine.make_refine_step over the mesh's 'lm' axis; without a
    mesh, on this device alone).

    Every configuration of the Slam runs in the lockstep step: every pose
    prediction, both map matchers (`matching_backend="banded"`: kernel K5
    over the rows), the classical and the learned frontend
    (`models.superpoint.SuperPointFrontend` over the S frames) and both
    frame matchers (`matcher="lightglue"`: kernel K6 over the rows that
    take the essential prediction). The rows that commit on a lockstep
    frame commit together: one K4 launch for those whose commit takes the
    reference shape, LightGlue's K6 once a site over their pairs, the
    window BA a row at a time. The Slams share one frontend (the
    first Slam's classical one when `frontend` is None), and so one frame
    matcher, whose LightGlue weights load once. Row i draws its
    RANSAC uniforms from its own Slam's generator, on the frames where it
    takes the essential prediction, so that its stream is its own Slam's;
    `adaptive` chooses per row from the row's previous inlier count, kept
    on the host from each lockstep frame's one read and from its
    bootstrap. Each row's essential predictions and banded fallbacks are
    counted (`essential_predictions`, `banded_fallbacks()`). The state
    lives on `device`, the card unless told otherwise."""

    def __init__(
        self,
        cam: Camera,
        videos: list,
        mesh=None,
        config: SlamConfig = SlamConfig(),
        static_mask: np.ndarray | None = None,
        seed: int = 0,
        frontend=None,
        refine_every: int = 0,
        refine_iters: int = 10,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cam = cam
        self.cfg = config
        S_local = len(videos)
        if S_local < 1:
            raise ValueError("MultiSlam needs at least one video")
        self.n_proc = dist.get_world_size() if dist.is_initialized() else 1
        if self.n_proc > 1:
            # Every rank must bring the same number of sequences: the row
            # blocks and every collective's shape follow from it, so uneven
            # counts would hang instead of failing (multi_seq.py:149-163).
            counts = [None] * self.n_proc
            dist.all_gather_object(counts, S_local)
            if any(c != S_local for c in counts):
                raise ValueError(f"uneven per-process sequence counts {counts}: every process "
                                 "must pass the same number of videos")
        self.S = S_local * axis_size(mesh, "seq")  # global sequence count
        self.local_rows = local_row_indices(mesh, self.S)
        # Seed per GLOBAL row, so that every layout of ranks draws the same
        # streams and a run over several ranks reproduces one process's.
        # The first Slam's frontend (its default one when `frontend` is
        # None) is every other's.
        self._slams = []
        for g, v in zip(self.local_rows, videos):
            self._slams.append(Slam(cam, v, config, static_mask=static_mask, seed=seed + g,
                                    frontend=frontend, device=self.device))
            frontend = self._slams[0].frontend
        self.frontend = frontend
        self._step = multi_sequence_step(cam=cam, cfg=config, frontend=self.frontend)
        self._mask = self._slams[0]._mask
        self.states: SlamState | None = None
        # Loss detection (Slam._batch_lost's rule): streaks over GLOBAL rows,
        # so that every rank decides the same.
        self._lost_streak = np.zeros(self.S, np.int64)
        self.finished = np.zeros(self.S, bool)  # EOF hit during a re-bootstrap
        self.segments: list = []
        self.refine_every = refine_every
        self._refine = None
        self.refine_costs: list = []
        # Host reads of the lockstep frames (one a frame, for all rows).
        self.host_syncs = 0
        self.frames_stepped = 0
        # Per local row: frames on the essential-matrix prediction, and the
        # banded matcher's dense fallbacks (on the device).
        self.essential_predictions = [0] * S_local
        self._band_fallbacks = torch.zeros((S_local,), dtype=torch.int64, device=self.device)
        if refine_every:
            from .refine import make_refine_step

            # Refinement moves poses and points only; the cached obs_desc
            # stays valid (descriptors never change).
            self._refine = make_refine_step(cam, mesh, max_iters=refine_iters)

    # -- cross-rank helpers (no-ops in one process) --------------------------
    def _allgather(self, x) -> np.ndarray:
        """This rank's rows [S_local, ...] -> all rows [S, ...] on every
        rank, in global row order (the 'lm' peers' copies are the same)."""
        x = np.asarray(x)
        if self.n_proc == 1:
            return x
        parts = [None] * self.n_proc
        dist.all_gather_object(parts, (self.local_rows[0], x))
        blocks = dict(parts)
        return np.concatenate([blocks[k] for k in sorted(blocks)], axis=0)

    # -- lifecycle -------------------------------------------------------------
    def initialize(self) -> bool:
        ok = all([s.initialize() for s in self._slams])
        if not bool(np.all(self._allgather([ok]))):
            return False
        self.states = stack_states([s.state for s in self._slams], device=self.device)
        return True

    def run_batched(self, max_frames: int | None = None, batch: int = 16) -> int:
        """Step every sequence `batch` frames per batch until all reach their
        end (or `max_frames` lockstep frames); returns the frames stepped.

        Each batch decodes `batch` frames of every row, uploads them in one
        copy, and steps them frame by frame (one host read a lockstep
        frame); rows whose stream ended are inactive and left as they were.
        Loss detection reads the PREVIOUS batch's inlier counts, as the JAX
        driver does; a refinement runs every `refine_every` batches."""
        assert self.states is not None, "call initialize() first"
        S_local = len(self._slams)
        H, W = self.cam.height, self.cam.width
        total = 0
        batches = 0
        pending: tuple | None = None
        while max_frames is None or total < max_frames:
            want = batch if max_frames is None else min(batch, max_frames - total)
            frames = [s._decode_batch(want) for s in self._slams]
            ns_global = self._allgather([len(f) for f in frames])
            n = int(ns_global.max())
            if n == 0:
                break
            imgs = np.zeros((n, S_local, H, W), np.uint8)
            for i, fl in enumerate(frames):
                for j, f in enumerate(fl):
                    imgs[j, i] = f
            imgs = self._slams[0]._upload(imgs)
            counts = np.zeros((S_local, n), np.int64)
            for j in range(n):
                active = [j < len(fl) for fl in frames]
                self.states, info = self._step(
                    self.states, imgs[j], active, self._mask,
                    [s._commit_no for s in self._slams], [s._gen for s in self._slams],
                    last_inliers=[s._last_inliers for s in self._slams])
                self.host_syncs += 1
                for i, s in enumerate(self._slams):
                    s._commit_no += info.is_keyframe[i]
                    s._last_inliers = info.n_inliers[i]
                    self.essential_predictions[i] += info.essential_prediction[i]
                if info.band_fallbacks is not None:
                    self._band_fallbacks += info.band_fallbacks
                counts[:, j] = info.n_inliers
            total += n
            batches += 1
            self.frames_stepped += n
            if self.cfg.reinit_on_lost:
                if pending is not None:
                    self._check_lost(*pending)
                pending = (self._allgather(counts), ns_global)
            if self._refine is not None and batches % self.refine_every == 0:
                self.refine_map()
        # The final pending check, so that a sequence lost in the last batch
        # still gets its segment archived.
        if pending is not None:
            self._check_lost(*pending)
        return total

    def banded_fallbacks(self) -> list[int]:
        """Per local row, the banded matcher's searches since the start
        whose band did not fit, so that the dense kernel did the search (a
        host read)."""
        return self._band_fallbacks.tolist()

    # -- failure detection / recovery ---------------------------------------
    def _check_lost(self, counts: np.ndarray, ns_global: np.ndarray) -> None:
        """Declare a sequence lost after `lost_patience` consecutive frames
        below `min_track_matches` inliers, archive its segment and
        re-bootstrap it from its stream position; the others go on. Every
        rank decides the same from the gathered counts; only the ranks
        holding a lost row touch it."""
        lost = []
        for g in range(self.S):
            if ns_global[g] == 0 or self.finished[g]:
                continue
            run = int(self._lost_streak[g])
            for c in counts[g, : ns_global[g]]:
                run = run + 1 if c < self.cfg.min_track_matches else 0
            self._lost_streak[g] = run
            if run >= self.cfg.lost_patience:
                lost.append(g)
        for g in lost:
            self._lost_streak[g] = 0
            if g in self.local_rows:
                self._reinit_sequence(g)

    def _reinit_sequence(self, g: int) -> None:
        """Archive global row g's segment and re-bootstrap it from its
        current stream position; a blank row if the stream ends first (the
        sequence is then finished, and its zero masks make it a no-op in
        refinement). The bootstrap seeds the row's commit number and its
        host inlier count (the adaptive prediction's signal) as Slam's own
        does."""
        i = self.local_rows.index(g)
        s = self._slams[i]
        s.state = tree_map(torch.clone, state_row(self.states, i))
        self.segments.append(dict(
            seq=g,
            poses=s.poses(include_archived=True),
            frame_indices=s.keyframe_indices(include_archived=True),
            points=s.points(),
        ))
        s.reset_state()
        if not s.initialize():
            self.finished[g] = True
        set_state_row(self.states, i, s.state)

    def refine_map(self) -> torch.Tensor:
        """One landmark-sharded full-map BA over all sequences now; the
        per-row final costs [S_local] (device tensor)."""
        assert self._refine is not None, "construct with refine_every > 0"
        self.states, cost = self._refine(self.states)
        self.refine_costs.append(cost)
        return cost

    def trajectory(self, i: int) -> list[dict]:
        """Local row i's trajectory segments: those archived at each loss,
        then the live map's (archived keyframes first), as dicts of
        `poses` [N, 4, 4] and `frame_indices` [N] (host arrays)."""
        s = self._slams[i]
        s.state = state_row(self.states, i)
        live = dict(poses=s.poses(include_archived=True),
                    frame_indices=s.keyframe_indices(include_archived=True))
        return [seg for seg in self.segments if seg["seq"] == self.local_rows[i]] + [live]

    def states_per_sequence(self) -> list[SlamState]:
        """This rank's sequences' states (copies), in `videos` order."""
        return [tree_map(torch.clone, state_row(self.states, i)) for i in range(len(self._slams))]
