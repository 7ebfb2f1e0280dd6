"""Weight bridge between the JAX package's parameter tree (as numpy)
and the port's modules, both ways, so both packages compute with the
same weights and read each other's checkpoints.

The JAX tree stacks every layer's leaves on a leading axis
(``layers.stacked_init``); the port holds one module per layer, so that
axis is unstacked into ``layers.<i>.<path>``. The stacked groups
(``STACKED``) are ``layers``, deepseek-moe's leading ``dense_layers``,
xLSTM's ``mlstm_layers`` and ``slstm_layers`` and Whisper's encoder
``enc_layers``; each has its own depth (``stack_depths``). Both packages
keep weights as [d_in, d_out], so every other leaf is a plain copy.
Loads are strict: every parameter on both sides must be matched.

The way back (``jax_tree``, ``params_tree``, ``state_tree``) nests the
port's parameter names on their dots and stacks ``<group>.<i>`` again as
a ``checkpoint.Stacked`` leaf that refers to the live tensors; the
``to_jax_*`` functions materialise it as numpy (bfloat16 as float32,
which holds it exactly).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import Stacked, paths_and_leaves
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


#: the tree's groups of layers stacked on a leading axis
STACKED = ("layers", "dense_layers", "mlstm_layers", "slstm_layers",
           "enc_layers")


def stack_depths(cfg: ModelConfig) -> Dict[str, int]:
    """{stacked group: depth} of a config's tree: an MoE config's dense
    prefix is ``dense_layers``, the rest ``layers``; xLSTM's mLSTM and
    sLSTM blocks (at least one mLSTM, as the reference keeps); Whisper's
    encoder and decoder."""
    if cfg.family == "ssm":
        n_s = len(cfg.xlstm.slstm_at)
        depths = {"mlstm_layers": max(cfg.num_layers - n_s, 1)}
        if n_s:
            depths["slstm_layers"] = n_s
        return depths
    if cfg.family == "audio":
        return {"layers": cfg.num_layers,
                "enc_layers": cfg.encdec.num_encoder_layers}
    fd = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    if fd:
        return {"layers": cfg.num_layers - fd, "dense_layers": fd}
    return {"layers": cfg.num_layers}


def state_dict_from_jax(tree: Mapping, num_layers: Union[int, Mapping]
                        ) -> Dict[str, np.ndarray]:
    """Flat {module path: array} with each stacked group's layer axis
    unstacked. ``num_layers``: the depth of ``layers``, or {group:
    depth} (``stack_depths``)."""
    depths = {"layers": num_layers} if isinstance(num_layers, int) \
        else dict(num_layers)
    flat = {}
    for name, arr in _flatten(tree).items():
        group, _, rest = name.partition(".")
        if group in STACKED and rest:
            n = depths.get(group)
            if arr.shape[0] != n:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                                 f"the config's {group} depth {n}")
            for i in range(n):
                flat[f"{group}.{i}.{rest}"] = arr[i]
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
                 state_dict_from_jax(tree, stack_depths(cfg)), dev)


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


# ---------------------------------------------------------------------------
# The way back: port modules -> the reference's tree
# ---------------------------------------------------------------------------

def _split_layer(name: str) -> Tuple[List[str], Optional[int]]:
    """'llm.layers.3.attn.wq' -> (['llm', 'layers', 'attn', 'wq'], 3);
    likewise under every ``STACKED`` group."""
    parts = name.split(".")
    for k in range(len(parts) - 1):
        if parts[k] in STACKED and parts[k + 1].isdigit():
            return parts[:k + 1] + parts[k + 2:], int(parts[k + 1])
    return parts, None


def jax_tree(named: Mapping[str, torch.Tensor]) -> dict:
    """{port name: tensor} -> the reference's nested tree: names nest on
    their dots and the layers of ``<a>.layers.<i>.<b>`` (or another
    ``STACKED`` group) stack again into one ``Stacked`` leaf at
    ``a/layers/b`` (layer order, which must be contiguous)."""
    tree: dict = {}
    stacks: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        keys, layer = _split_layer(name)
        if layer is None:
            _put(tree, keys, t, name)
        else:
            stacks.setdefault(tuple(keys), {})[layer] = t
    for keys, by_layer in stacks.items():
        order = sorted(by_layer)
        if order != list(range(order[0], order[0] + len(order))):
            raise ValueError(f"{'/'.join(keys)}: layers {order} are not "
                             f"contiguous")
        _put(tree, list(keys), Stacked([by_layer[i] for i in order]),
             "/".join(keys))
    return tree


def _put(tree: dict, keys: List[str], leaf, name: str) -> None:
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"{name}: {k!r} is both a leaf and a subtree")
    if keys[-1] in node:
        raise ValueError(f"{name}: path held twice")
    node[keys[-1]] = leaf


def _stage_names(stage) -> Dict[str, torch.Tensor]:
    """A ``models.stages.StageParams``' parameters under the reference's
    stage-tree names: the ``encoders.<m>.module.``, ``encoders.<m>.``
    and ``llm.`` prefixes dropped."""
    out = {}
    for name, p in stage.named_parameters():
        parts = name.split(".")
        if parts[0] == "encoders":
            parts = parts[3:] if parts[2] == "module" else parts[2:]
        elif parts[0] == "llm":
            parts = parts[1:]
        out[".".join(parts)] = p
    return out


def _named(params) -> Tuple[Any, Dict[int, str]]:
    """(the reference-layout tree of ``params``, {id(tensor): optimizer
    key}). ``params`` is a module (keys are its parameter names) or a
    stage list (keys ``"<stage>:<name>"``, as ``make_spmd_train_step``
    keys its state)."""
    if isinstance(params, (list, tuple)):
        keys = {id(p): f"{s}:{n}" for s, st in enumerate(params)
                for n, p in st.named_parameters()}
        return [jax_tree(_stage_names(st)) for st in params], keys
    named = dict(params.named_parameters())
    return jax_tree(named), {id(p): n for n, p in named.items()}


def params_tree(params):
    """The reference-layout tree over a module's or a stage list's live
    parameters (see ``_named``)."""
    return _named(params)[0]


def _slot_tree(ptree, slot_of):
    """The optimizer-slot tree matching ``ptree``: each leaf's slot
    tensors (``slot_of(param)``), or the reference's (0,) f32
    placeholder where the leaf is frozen (no slot)."""
    def leaf(x):
        parts = x.parts if isinstance(x, Stacked) else [x]
        slots = [slot_of(p) for p in parts]
        if all(s is None for s in slots):
            return torch.zeros((0,), dtype=torch.float32,
                               device="meta" if parts[0].is_meta else "cpu")
        if any(s is None for s in slots):
            raise ValueError("a stacked leaf is frozen only in part")
        return Stacked(slots) if isinstance(x, Stacked) else slots[0]

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return leaf(node)
    return walk(ptree)


def _opt_tree(ptree, keys: Dict[int, str], opt_state: Mapping):
    """{"m", "step", "v"} in the reference's layout. A parameter on the
    meta device (another rank's) gets a meta slot, or none if it is
    frozen (``requires_grad`` off)."""
    def slot(kind):
        def of(p):
            if p.is_meta:
                return torch.empty(p.shape, dtype=torch.float32,
                                   device="meta") if p.requires_grad \
                    else None
            return opt_state[kind][keys[id(p)]]
        return of
    return {"m": _slot_tree(ptree, slot("m")),
            "step": np.asarray(opt_state["step"], np.int32),
            "v": _slot_tree(ptree, slot("v"))}


def state_tree(params, opt_state: Mapping, health: Mapping) -> dict:
    """The training state ``{"params", "opt", "health"}`` in the
    reference's checkpoint layout, over the live tensors (a restore
    writes into them): AdamW's ``step`` as an int32 scalar, a frozen
    leaf's moments as the (0,) f32 placeholder, the health EMA as
    f32/f32/int32 scalars."""
    ptree, keys = _named(params)
    return {"health": {"count": np.asarray(health["count"], np.int32),
                       "ema": np.asarray(health["ema"], np.float32),
                       "var": np.asarray(health["var"], np.float32)},
            "opt": _opt_tree(ptree, keys, opt_state),
            "params": ptree}


def _to_numpy(tree):
    """A tree's leaves as numpy (Stacked stacked; bf16 as f32)."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, Stacked):
            return np.stack([conv(p) for p in node.parts])
        if isinstance(node, torch.Tensor):
            return conv(node)
        return np.asarray(node)
    return walk(tree)


def _check_depth(tree: Mapping, num_layers: Union[int, Mapping],
                 what: str) -> None:
    depths = {"layers": num_layers} if isinstance(num_layers, int) \
        else num_layers
    for group in STACKED:
        for path, leaf in paths_and_leaves(tree.get(group, {})):
            if leaf.shape[0] != depths.get(group):
                raise ValueError(
                    f"{what}{group}/{path}: {leaf.shape[0]} layers, the "
                    f"config has {depths.get(group)}")


def to_jax_params(model, cfg: ModelConfig) -> dict:
    """The JAX package's parameter tree (numpy leaves) of a port model:
    the inverse of ``from_jax_params``."""
    tree = jax_tree(dict(model.named_parameters()))
    _check_depth(tree, stack_depths(cfg), "")
    return _to_numpy(tree)


def mllm_to_jax_params(params, mllm) -> dict:
    """The JAX package's ``MultimodalModule.init`` tree (numpy leaves) of
    the port's ``MLLMParams``: the inverse of ``mllm_from_jax_params``."""
    tree = jax_tree(dict(params.named_parameters()))
    if set(tree.get("encoders", {})) != set(mllm.encoders):
        raise KeyError(f"encoders {sorted(tree.get('encoders', {}))} are "
                       f"not the module's ({sorted(mllm.encoders)})")
    for name, enc in mllm.encoders.items():
        _check_depth(tree["encoders"][name]["module"], enc.cfg.num_layers,
                     f"encoders/{name}/module/")
    _check_depth(tree["llm"], mllm.llm_cfg.num_layers, "llm/")
    return _to_numpy(tree)


def opt_state_to_jax(opt_state: Mapping, params) -> dict:
    """The reference's AdamW state ``{"step", "m", "v"}`` (numpy leaves,
    frozen slots as the (0,) f32 placeholder) of the port's state over
    ``params`` (a module or a stage list)."""
    ptree, keys = _named(params)
    return _to_numpy(_opt_tree(ptree, keys, opt_state))


def opt_state_from_jax(tree: Mapping, params) -> dict:
    """The port's AdamW state over ``params`` (a module or a stage list)
    from the reference's ``{"step", "m", "v"}`` (numpy leaves): the
    inverse of ``opt_state_to_jax``. Slots land on their parameter's
    device in f32; a (0,) placeholder becomes ``None``."""
    ptree, keys = _named(params)
    flat_p = paths_and_leaves(ptree)
    out = {"step": int(np.asarray(tree["step"])), "m": {}, "v": {}}
    for kind in ("m", "v"):
        flat_s = dict(paths_and_leaves(tree[kind]))
        for path, leaf in flat_p:
            arr = np.asarray(flat_s[path])
            parts = leaf.parts if isinstance(leaf, Stacked) else [leaf]
            for k, p in enumerate(parts):
                if arr.shape == (0,):
                    out[kind][keys[id(p)]] = None
                    continue
                a = arr[k] if isinstance(leaf, Stacked) else arr
                out[kind][keys[id(p)]] = torch.from_numpy(
                    np.array(a, np.float32)).to(p.device)
    return out
