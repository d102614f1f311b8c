"""World state between the JAX package and the port, through numpy.

`state_from_numpy(tree, device)` takes a JAX `SlamState` whose leaves were
made numpy (for example `jax.tree.map(np.asarray, state)`; any object with
the same field names works) and builds the port's `SlamState` on `device`.
`state_to_numpy(state)` goes back: the port's NamedTuples with numpy leaves
in the JAX package's dtypes (int32 indices, float32 for the bf16 cache).
bf16 leaves travel as float32; their values are bf16-representable, so the
round trip is exact. The classical path has no learned weights; its one
fixed weight, the descriptor projection, is rebuilt bit-identically by
ops/descriptors.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..slam.state import Features, KeyframeStore, MapState, SlamState

_NESTED = {"kfs": KeyframeStore, "map": MapState, "last_feat": Features}
_BF16 = {"obs_desc"}


def _leaf_to_torch(name: str, x, device) -> torch.Tensor:
    a = np.asarray(x)
    if name in _BF16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(device).to(torch.bfloat16)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def _from(cls, tree, device):
    vals = {}
    for f in cls._fields:
        sub = getattr(tree, f)
        vals[f] = _from(_NESTED[f], sub, device) if f in _NESTED else _leaf_to_torch(f, sub, device)
    return cls(**vals)


def state_from_numpy(tree, device="cpu") -> SlamState:
    """JAX SlamState with numpy leaves -> the port's SlamState on `device`."""
    return _from(SlamState, tree, torch.device(device))


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()
    if t.dtype == torch.int64:
        return t.numpy().astype(np.int32)
    return t.numpy()


def _to(obj: NamedTuple):
    return type(obj)(*[
        _to(v) if isinstance(v, tuple) else _leaf_to_numpy(v) for v in obj
    ])


def state_to_numpy(state: SlamState) -> SlamState:
    """The port's SlamState -> the same structure with numpy leaves."""
    return _to(state)
