"""Weight bridge: the JAX package's parameter tree (as numpy) -> the
port's modules, so both packages compute with the same weights.

The JAX tree stacks every layer's leaves on a leading axis
(``layers.stacked_init``); the port holds one ``Block`` per layer, so
that axis is unstacked into ``layers.<i>.<path>``. Both packages keep
weights as [d_in, d_out], so every other leaf is a plain copy.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.transformer import torch_dtype


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, name + "."))
        else:
            flat[name] = np.asarray(val)
    return flat


def state_dict_from_jax(tree: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    """Flat {module path: array} with the layer axis unstacked."""
    flat = {}
    for name, arr in _flatten(tree).items():
        if name.startswith("layers."):
            if arr.shape[0] != num_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                                 f"num_layers {num_layers}")
            rest = name[len("layers."):]
            for i in range(num_layers):
                flat[f"layers.{i}.{rest}"] = arr[i]
        else:
            flat[name] = arr
    return flat


def from_jax_params(tree: Mapping, cfg: ModelConfig, device="cuda"):
    """A port model on ``device`` holding the JAX tree's weights (numpy
    leaves, e.g. ``jax.tree.map(np.asarray, params)``), in cfg's dtype.
    Every parameter must be matched exactly (strict load)."""
    dev = resolve_device(device)
    model = api.init(cfg, device="meta")
    dtype = torch_dtype(cfg)
    state = {name: torch.from_numpy(np.array(arr, np.float32)).to(dtype)
             for name, arr in state_dict_from_jax(tree, cfg.num_layers).items()}
    model = model.to_empty(device=dev)
    model.load_state_dict(state, strict=True)
    return model
