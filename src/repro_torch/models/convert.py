"""Carry a reference param tree over to the port's model.

``params_from_jax(tree, cfg)`` takes the reference package's param pytree
as nested dicts of NumPy arrays (``jax.tree.map(np.asarray, params)``) and
returns a state dict for ``Model(cfg)``: the stacked ``layers`` (a leading
``n_layers`` axis under ``slot0``, the dense family's one-block period)
are split into ``layers.<i>.…``, every other leaf keeps its path with
``/`` joined as ``.``.  Weights are ``(d_in, d_out)`` on both sides, so
values carry over unchanged; bfloat16 leaves (ml_dtypes arrays) keep
their bits.  A leaf the model lacks, a parameter the tree lacks or a
shape that differs raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .model import Model


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """The reference's param tree -> the port's state dict (CPU tensors
    in the tree's dtype; ``load_state_dict`` moves and casts them)."""
    state = {}
    for name, leaf in _flatten(tree).items():
        if name.startswith("layers."):
            slot, rest = name[len("layers."):].split(".", 1)
            if slot != "slot0":
                raise ValueError(f"unused leaf {name!r}: the dense decoder "
                                 f"has one block a period")
            leaf = np.asarray(leaf)
            if leaf.ndim == 0 or leaf.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis of {leaf.shape} is "
                                 f"not n_layers={cfg.n_layers}")
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{rest}"] = _tensor(leaf[i])
        else:
            state[name] = _tensor(leaf)
    want = {k: tuple(v.shape)
            for k, v in Model(cfg, device="meta").state_dict().items()}
    unused = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    if unused or missing:
        raise ValueError(f"param tree for {cfg.name}: unused leaves "
                         f"{unused}, missing leaves {missing}")
    for k, shape in want.items():
        if tuple(state[k].shape) != shape:
            raise ValueError(f"{k}: shape {tuple(state[k].shape)}, the "
                             f"model's {shape}")
    return state
