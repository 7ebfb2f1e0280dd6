"""Weight bridge: the JAX package's parameter tree (as numpy) -> the
port's modules, so both packages compute with the same weights.

The JAX tree stacks every layer's leaves on a leading axis
(``layers.stacked_init``); the port holds one module per layer, so that
axis is unstacked into ``layers.<i>.<path>``. Both packages keep
weights as [d_in, d_out], so every other leaf is a plain copy. Loads are
strict: every parameter on both sides must be matched.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api


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


def _load(model: torch.nn.Module, flat: Mapping[str, np.ndarray], dev):
    """Materialise a meta-device ``model`` on ``dev`` and copy ``flat``
    into it strictly; each leaf is cast to its parameter's dtype."""
    model = model.to_empty(device=dev)
    state = {name: torch.from_numpy(np.array(arr, np.float32))
             for name, arr in flat.items()}
    model.load_state_dict(state, strict=True)
    return model


def from_jax_params(tree: Mapping, cfg: ModelConfig, device="cuda"):
    """A port model on ``device`` holding the JAX tree's weights (numpy
    leaves, e.g. ``jax.tree.map(np.asarray, params)``), in cfg's dtype."""
    dev = resolve_device(device)
    return _load(api.init(cfg, device="meta"),
                 state_dict_from_jax(tree, cfg.num_layers), dev)


def mllm_from_jax_params(tree: Mapping, mllm, device="cuda"):
    """The port's ``MLLMParams`` for a ``core.modality.MultimodalModule``
    from the JAX package's ``MultimodalModule.init`` tree (numpy leaves):
    ``encoders.<name>.module`` (layer axis unstacked with that encoder's
    depth), ``encoders.<name>.projector``, ``llm``. Frozen parts get
    ``requires_grad=False``."""
    dev = resolve_device(device)
    flat = {}
    for name, enc in tree["encoders"].items():
        if name not in mllm.encoders:
            raise KeyError(f"encoder {name!r} is not in the module "
                           f"({sorted(mllm.encoders)})")
        depth = mllm.encoders[name].cfg.num_layers
        for key, arr in state_dict_from_jax(enc["module"], depth).items():
            flat[f"encoders.{name}.module.{key}"] = arr
        for key, arr in _flatten(enc["projector"]).items():
            flat[f"encoders.{name}.projector.{key}"] = arr
    for key, arr in state_dict_from_jax(
            tree["llm"], mllm.llm_cfg.num_layers).items():
        flat[f"llm.{key}"] = arr
    extra = set(tree) - {"encoders", "llm"}
    if extra:
        raise KeyError(f"unexpected top-level keys {sorted(extra)}")
    params = _load(mllm.init(device="meta"), flat, dev)
    mllm.apply_freeze(params)
    return params
