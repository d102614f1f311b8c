"""World state and weights between the JAX package and the port, through numpy.

`state_from_numpy(tree, device)` takes a JAX `SlamState` whose leaves were
made numpy (for example `jax.tree.map(np.asarray, state)`; any object with
the same field names works) and builds the port's `SlamState` on `device`.
`state_to_numpy(state)` goes back: the port's NamedTuples with numpy leaves
in the JAX package's dtypes (int32 indices, float32 for the bf16 cache).
bf16 leaves travel as float32; their values are bf16-representable, so the
round trip is exact. The classical path's one fixed weight, the
descriptor projection, is rebuilt bit-identically by ops/descriptors.py.

`superpoint_params_from_numpy` and `lightglue_params_from_numpy` build the
learned path's parameters from the leaves of the JAX package's parameter
pytrees (`jax.tree_util.tree_leaves` order, as numpy arrays);
`superpoint_params_to_numpy` and `lightglue_params_to_numpy` go back. The
.npz loaders and savers of `models.superpoint` and `models.lightglue` are
thin wrappers.
"""

from __future__ import annotations

from collections.abc import Iterator
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.lightglue import LayerParams, LightGlueParams
from ..models.superpoint import SuperPointParams
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


def state_from_numpy(tree, device="cuda") -> SlamState:
    """JAX SlamState with numpy leaves -> the port's SlamState on `device`."""
    return _from(SlamState, tree, resolve_device(device))


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


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a parameter tree (NamedTuples and tuples of tensors)
    in the JAX pytree's leaf order."""
    for x in tree:
        if isinstance(x, tuple):
            yield from tree_leaves(x)
        else:
            yield x


def _param_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def superpoint_params_from_numpy(leaves, device="cuda") -> SuperPointParams:
    """The 24 leaves of a JAX SuperPointParams (conv_w x8, conv_b x8, det_w x2,
    det_b x2, desc_w x2, desc_b x2) -> the port's parameters on `device`;
    kernels go from HWIO to OIHW."""
    if len(leaves) != 24:
        raise ValueError(f"SuperPoint has 24 parameter leaves, got {len(leaves)}")
    dev = resolve_device(device)

    def t(a):
        a = torch.from_numpy(np.array(a, np.float32))
        return (a.permute(3, 2, 0, 1).contiguous() if a.dim() == 4 else a).to(dev)

    x = [t(a) for a in leaves]
    return SuperPointParams(conv_w=tuple(x[0:8]), conv_b=tuple(x[8:16]), det_w=tuple(x[16:18]),
                            det_b=tuple(x[18:20]), desc_w=tuple(x[20:22]),
                            desc_b=tuple(x[22:24]))


def lightglue_params_from_numpy(leaves, in_dim: int, dim: int, n_layers: int,
                                device="cuda") -> LightGlueParams:
    """The leaves of a JAX LightGlueParams (in_proj_w, 8 per layer in
    LayerParams field order, match_proj_w, matchability_w, matchability_b)
    -> the port's parameters on `device`, [in, out] orientation kept."""
    n = 4 + 8 * n_layers
    if len(leaves) != n:
        raise ValueError(f"LightGlue with {n_layers} layers has {n} leaves, got {len(leaves)}")
    dev = resolve_device(device)
    x = [torch.from_numpy(np.array(a, np.float32)).to(dev) for a in leaves]
    if tuple(x[0].shape) != (in_dim, dim):
        raise ValueError(f"in_proj_w has shape {tuple(x[0].shape)}, expected {(in_dim, dim)}")
    layers = tuple(LayerParams(*x[1 + 8 * i: 9 + 8 * i]) for i in range(n_layers))
    return LightGlueParams(in_proj_w=x[0], layers=layers, match_proj_w=x[-3],
                           matchability_w=x[-2], matchability_b=x[-1])


def superpoint_params_to_numpy(params: SuperPointParams) -> list[np.ndarray]:
    """The port's SuperPoint parameters -> the 24 float32 leaves of the JAX
    pytree, kernels from OIHW to HWIO (the inverse of
    `superpoint_params_from_numpy`)."""
    return [_param_to_numpy(t.permute(2, 3, 1, 0) if t.dim() == 4 else t)
            for t in tree_leaves(params)]


def lightglue_params_to_numpy(params: LightGlueParams) -> list[np.ndarray]:
    """The port's LightGlue parameters -> the float32 leaves of the JAX
    pytree (the inverse of `lightglue_params_from_numpy`)."""
    return [_param_to_numpy(t) for t in tree_leaves(params)]
