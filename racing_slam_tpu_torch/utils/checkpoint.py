"""Checkpoint and resume of the whole SLAM state, in the JAX package's npz
format (racing_slam_tpu/utils/checkpoint.py), so that a file written by
either package loads in the other.

Format v2: each leaf is stored under its dotted field path ("kfs.rvec",
"map.pos", ..., "last_inliers") beside a `__format_version__` marker, in
the JAX package's dtypes: int32 indices and counters, bool masks, float32
values, and the bf16 `obs_desc` as float32 under "obs_desc__bf16" (npz has
no bf16). Fields absent from a file are backfilled from `SlamState.create`;
a v1 file (positional "leaf_N", the state before the archive fields) is
mapped onto the current names. `load_state` casts every leaf to the port's
dtype (int64 indices, bf16 cache) on the device asked for.

`save_state_sharded` / `load_state_sharded` keep a multi-sequence state
(a leading S axis, this rank's rows of a MultiSlam) through
`torch.distributed.checkpoint`, the counterpart of the JAX package's orbax
backend (checkpoint.py:134-147): every rank writes its own rows, each
under its global row number, into one checkpoint directory, and reads
them back. It runs in one process too, with no process group.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..slam.state import SlamState
from .convert import _leaf_to_numpy

FORMAT_VERSION = 2

# v1 held the state without these fields, appended since; without them the
# current field order is v1's leaf order.
_V1_ABSENT = ("arch_rvec", "arch_t", "arch_frame_index", "arch_count", "last_inliers")


def _named_leaves(state: SlamState) -> dict[str, torch.Tensor]:
    """{dotted field path: leaf} in field order, as the JAX package names
    its pytree's leaves."""
    out = {}
    for name, value in zip(state._fields, state):
        if isinstance(value, tuple):
            out.update({f"{name}.{k}": v for k, v in _named_leaves(value).items()})
        else:
            out[name] = value
    return out


def save_state(path: str | Path, state: SlamState) -> None:
    out = {"__format_version__": np.int64(FORMAT_VERSION)}
    for name, x in _named_leaves(state).items():
        key = f"{name}__bf16" if x.dtype == torch.bfloat16 else name
        out[key] = _leaf_to_numpy(x)
    np.savez_compressed(path, **out)


def _load_v1(data) -> dict[str, np.ndarray]:
    """A v1 positional file's leaves under the current field names."""
    template = SlamState.create(F=1, P=1, O=1, K=1, D=1, A=1, device="cpu")
    names = [n for n in _named_leaves(template) if n not in _V1_ABSENT]
    if len(data.files) != len(names):
        raise ValueError(f"v1 checkpoint has {len(data.files)} leaves; the v1 layout "
                         f"has {len(names)} (the state before the archive fields)")
    return {name: data[f"leaf_{i}"] if f"leaf_{i}" in data else data[f"leaf_{i}__bf16"]
            for i, name in enumerate(names)}


def load_state(path: str | Path, archive_capacity: int | None = None,
               device="cuda") -> SlamState:
    """Restore a SlamState on `device` (the card unless told otherwise).
    `archive_capacity` sizes the backfilled archive of a file written
    before the archive fields (512 by default; pass the engine's
    SlamConfig.archive_capacity)."""
    with np.load(path) as data:
        if "__format_version__" not in data.files:
            stored = _load_v1(data)
        else:
            stored = {f.removesuffix("__bf16"): data[f] for f in data.files
                      if f != "__format_version__"}

    F, K, D = stored["kfs.desc"].shape
    P, O = stored["map.obs_kf"].shape
    if "arch_frame_index" in stored:
        A = stored["arch_frame_index"].shape[0]
    else:
        A = 512 if archive_capacity is None else archive_capacity
    template = SlamState.create(F=F, P=P, O=O, K=K, D=D, A=A, device=device)
    leaves = _named_leaves(template)
    unknown = set(stored) - set(leaves)
    if unknown:
        raise ValueError(f"{path} holds fields this SlamState does not have: {sorted(unknown)}")
    flat = [torch.from_numpy(np.asarray(stored[n])).to(x.device, x.dtype) if n in stored else x
            for n, x in leaves.items()]
    return _unflatten(template, iter(flat))


def _unflatten(template, leaves):
    """`template`'s NamedTuple structure with its leaves taken in order."""
    return type(template)(*[_unflatten(v, leaves) if isinstance(v, tuple) else next(leaves)
                            for v in template])


def _row_leaves(states: SlamState, rows: list) -> dict[str, torch.Tensor]:
    """{"seq<g>/<dotted field>": leaf row} for the stacked state's rows,
    `rows` their global numbers."""
    return {f"seq{g}/{name}": x[i] for name, x in _named_leaves(states).items()
            for i, g in enumerate(rows)}


def save_state_sharded(path: str | Path, states: SlamState, rows: list | None = None) -> None:
    """Write a stacked state's rows (global numbers `rows`, by default 0..S-1)
    to the checkpoint directory `path` with torch.distributed.checkpoint;
    under a process group every rank calls it with its own rows."""
    import torch.distributed.checkpoint as dcp

    S = states.num_kf.shape[0]
    rows = list(range(S)) if rows is None else list(rows)
    dcp.save(_row_leaves(states, rows), checkpoint_id=str(path))


def load_state_sharded(path: str | Path, template: SlamState, rows: list | None = None
                       ) -> SlamState:
    """Read the rows `rows` (global numbers, by default 0..S-1) of a
    checkpoint written by save_state_sharded into `template`, a stacked
    state of the same shapes on the device wanted (MultiSlam's own, or
    multi_seq.batched_state); `template` is filled in place and returned."""
    import torch.distributed.checkpoint as dcp

    S = template.num_kf.shape[0]
    rows = list(range(S)) if rows is None else list(rows)
    leaves = _row_leaves(template, rows)
    dcp.load(leaves, checkpoint_id=str(path))
    return template
