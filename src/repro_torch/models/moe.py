"""Mixture-of-Experts decoder family (qwen2-moe-a2.7b, deepseek-moe-16b),
the counterpart of ``repro.models.moe``.

Fine-grained MoE with shared experts (DeepSeekMoE, arXiv:2401.06066;
Qwen1.5-MoE): each layer = GQA attention + [shared experts (always-on
dense MLP) + routed experts (top-k)]. The layers are the dense
transformer's (``transformer._block``) with the routed FFN as its
``ffn`` hook; deepseek-moe's leading dense layers sit in
``dense_layers``, outside the MoE stack, as in the JAX tree.

Two dispatch backends (``cfg.moe.backend``):

* ``capacity``: GShard-style fixed-capacity scatter, row-local. Each
  (token, k) pair takes the next slot of its expert's buffer by a
  cumulative count along the row; pairs beyond
  ``cap = int(T*K/E * capacity_factor) + 1`` are dropped. The experts
  run as batched matmuls over the stacked expert axis.
* ``dense``: every expert computes every token, combined with the
  routing weights (exact, for tests).

Router aux loss: Switch-style load balance ``E * Σ_e f_e · p_e`` (f the
fraction of tokens routed to e, p the mean router probability of e).

Under context parallelism (``cfg.cp_mesh``, set by
``training.steps.make_cp_train_step``) a rank holds its run of the
permuted sequence, where the JAX CP step runs the whole permuted row.
So the aux loss all-reduces the expert histogram (no grad) and the token
count over the group, and each rank contributes its own probability
sums: the summed loss and gradients are the whole row's. The capacity
backend all-gathers the group's expert ids in plan order, counts slots
over the whole row with the whole row's ``cap`` and keeps its run's
decisions; an expert's output for a token does not depend on the other
tokens in its buffer, so the result is the JAX step's.

The JAX package's expert-parallel ``_shardmap_dispatch`` (a mesh with a
``model`` axis) is not ported: ROADMAP.md item 27.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

BACKENDS = ("capacity", "dense")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class MoEFFN(nn.Module):
    """Router [d, E], stacked expert weights w_gate/w_up [E_pad, d, de]
    and w_down [E_pad, de, d] (padded experts are never routed to), and
    the shared experts as one gated MLP of width de x shared."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        m = cfg.moe
        d, de, ep = cfg.d_model, m.d_expert, m.num_experts_padded
        self.router = L.normal_param((d, m.num_experts), dtype, device,
                                     generator)
        self.w_gate = L.normal_param((ep, d, de), dtype, device, generator)
        self.w_up = L.normal_param((ep, d, de), dtype, device, generator)
        self.w_down = L.normal_param((ep, de, d), dtype, device, generator)
        self.shared = L.MLP(d, de * m.num_shared_experts, dtype, device,
                            generator, gated=True) \
            if m.num_shared_experts else None

    def forward(self, h, cfg: ModelConfig):
        """``moe_ffn``: (out, aux). Called as a module, so forward hooks
        see each MoE layer's input."""
        return moe_ffn(self, h, cfg)


def _moe_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of the MoE stack: the layers after the dense prefix."""
    return cfg.replace(num_layers=cfg.num_layers - cfg.moe.first_dense_layers)


def init(cfg: ModelConfig, *, device="cuda", generator=None):
    """A ``TransformerLM`` whose ``layers`` hold the MoE layers, plus
    ``dense_layers`` (deepseek-moe's leading dense layers) when the
    config has them."""
    dev = resolve_device(device)
    dtype = T.torch_dtype(cfg)
    model = T.init(_moe_cfg(cfg), device=dev, generator=generator,
                   ffn_init=lambda dt, dv, g: MoEFFN(cfg, dt, dv, g))
    if cfg.moe.first_dense_layers:
        model.dense_layers = nn.ModuleList(
            T.Block(cfg, dtype, dev, generator)
            for _ in range(cfg.moe.first_dense_layers))
    return model


# ---------------------------------------------------------------------------
# Routed-expert dispatch
# ---------------------------------------------------------------------------

def router_probs(lp: MoEFFN, h, cfg: ModelConfig):
    """(probs [B,T,E] f32, renormalised top-k weights [B,T,K], top-k
    expert ids [B,T,K])."""
    probs = torch.softmax((h @ lp.router).float(), dim=-1)
    w, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)
    return probs, w, idx


def aux_loss(probs, idx, cfg: ModelConfig):
    """``E * coef * Σ_e f_e · p_e``; under CP this rank's share of the
    whole row's value (see the module docstring)."""
    m = cfg.moe
    E = m.num_experts
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    n = torch.tensor(float(idx.numel() // m.top_k), device=probs.device)
    psum = probs.reshape(-1, E).sum(dim=0)
    if cfg.cp_mesh is not None:
        stats = torch.cat([counts, n[None]])
        dist.all_reduce(stats, group=cfg.cp_mesh)
        counts, n = stats[:E], stats[E]
    return E * torch.sum((counts / n) * (psum / n)) * m.router_aux_coef


def _dense_dispatch(lp: MoEFFN, h, w, idx, cfg: ModelConfig):
    """Exact reference: every (real) expert on every token, weighted
    combine."""
    E = cfg.moe.num_experts
    g = torch.einsum("btd,edf->ebtf", h, lp.w_gate[:E])
    u = torch.einsum("btd,edf->ebtf", h, lp.w_up[:E])
    out_e = torch.einsum("ebtf,efd->ebtd", F.silu(g) * u, lp.w_down[:E])
    onehot = F.one_hot(idx, E).to(h.dtype)                 # [B,T,K,E]
    weight = torch.einsum("btke,btk->ebt", onehot, w.to(h.dtype))
    return torch.einsum("ebt,ebtd->btd", weight, out_e)


def _row_slots(idx_f, E: int, group):
    """0-based slot of each (token, k) pair in its expert's buffer: the
    pair's 1-based count among the row's pairs for that expert, minus 1.
    idx_f: [B, n] expert ids in row order. With a CP group the count runs
    over the whole row: the group's ids gathered in plan order (rank r
    holds run r); this rank's pairs are returned."""
    full, lo = idx_f, 0
    if group is not None:
        parts = [torch.empty_like(idx_f)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, idx_f.contiguous(), group=group)
        full = torch.cat(parts, dim=1)
        lo = dist.get_rank(group) * idx_f.shape[1]
    # [B, E, n] with the pairs on the last axis: a scan along the
    # innermost axis runs a row per expert in parallel, where one along
    # the pair axis of [B, n, E] walks n serially (2.3 ms a layer at
    # deepseek-moe's 12288 pairs on the H100)
    onehot = (full[:, None, :] == torch.arange(
        E, device=full.device)[None, :, None]).to(torch.int32)
    slot = (torch.cumsum(onehot, dim=-1) * onehot).sum(dim=1) - 1
    return slot[:, lo:lo + idx_f.shape[1]]


def capacity_slots(idx, cfg: ModelConfig):
    """(slot [B, T*K], cap): each (token, k) pair's 0-based slot in its
    expert's buffer, and the buffer's size; pairs at slot >= cap are
    dropped. Under CP the slots and cap are the whole row's."""
    m = cfg.moe
    B, T_, K = idx.shape
    group = cfg.cp_mesh
    t_row = T_ * (dist.get_world_size(group) if group is not None else 1)
    cap = int((t_row * K / m.num_experts) * m.capacity_factor) + 1
    return _row_slots(idx.reshape(B, T_ * K), m.num_experts_padded,
                      group), cap


def _capacity_dispatch(lp: MoEFFN, h, w, idx, cfg: ModelConfig):
    """GShard-style fixed-capacity scatter dispatch, row-local: slots,
    scatter and gather stay within each batch row. Pairs beyond ``cap``
    are dropped (their routed output is 0)."""
    B, T_, d = h.shape
    K, E = cfg.moe.top_k, cfg.moe.num_experts_padded

    idx_f = idx.reshape(B, T_ * K)
    w_f = w.reshape(B, T_ * K)
    tok = torch.arange(T_, device=h.device).repeat_interleave(K)
    rows = torch.arange(B, device=h.device)[:, None].expand(B, T_ * K)
    slot, cap = capacity_slots(idx, cfg)
    keep = (slot >= 0) & (slot < cap)
    # dropped pairs land in a spare slot ``cap`` that no expert reads,
    # so the kept pairs' (row, expert, slot) are unique and the scatter
    # needs no accumulation
    slot_s = torch.where(keep, slot, cap)
    src = torch.where(keep[..., None], h[:, tok], 0).to(h.dtype)
    buf = torch.zeros((B, E, cap + 1, d), dtype=h.dtype, device=h.device)
    buf = buf.index_put((rows, idx_f, slot_s), src)[:, :, :cap]

    g = torch.einsum("becd,edf->becf", buf, lp.w_gate)
    u = torch.einsum("becd,edf->becf", buf, lp.w_up)
    out_buf = torch.einsum("becf,efd->becd", F.silu(g) * u, lp.w_down)

    got = out_buf[rows, idx_f, slot.clamp(0, cap - 1)]      # [B, T*K, d]
    got = torch.where(keep[..., None], got, 0) * w_f[..., None].to(h.dtype)
    return got.reshape(B, T_, K, d).sum(dim=2)


def _pick_dispatch(lp: MoEFFN, h, w, idx, cfg: ModelConfig):
    backend = cfg.moe.backend
    if backend == "dense":
        return _dense_dispatch(lp, h, w, idx, cfg)
    if backend == "capacity":
        return _capacity_dispatch(lp, h, w, idx, cfg)
    raise ValueError(f"moe backend {backend!r}; the port has {BACKENDS} "
                     f"(expert-parallel dispatch: ROADMAP.md item 27)")


def moe_ffn(lp: MoEFFN, h, cfg: ModelConfig):
    """Full MoE FFN: shared experts + routed top-k. Returns (out, aux)."""
    probs, w, idx = router_probs(lp, h, cfg)
    out = _pick_dispatch(lp, h, w, idx, cfg)
    if lp.shared is not None:
        out = out + L.run_mlp(lp.shared, h, cfg.act)
    return out, aux_loss(probs, idx, cfg)


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------

def _ffn_hook(cfg: ModelConfig):
    def ffn(lp, h, layer_idx):
        return lp.mlp(h, cfg)
    return ffn


def hidden(model, cfg: ModelConfig, batch):
    """(final hidden [B,T,d], {"aux_loss": Σ over the MoE layers})."""
    x = T.embed_tokens(model, cfg, batch)
    if cfg.moe.first_dense_layers:
        x, _ = T.run_layers(cfg, model.dense_layers, batch, x)
    x, aux = T.run_layers(_moe_cfg(cfg), model.layers, batch, x,
                          _ffn_hook(cfg))
    return L.apply_norm(cfg, model.final_ln, x), T.aux_dict(aux, x)


def forward(model, cfg: ModelConfig, batch):
    h, aux = hidden(model, cfg, batch)
    return T.unembed(model, cfg, h), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device="cuda"):
    """Strip cache of the MoE layers (k, v [L - dense, B, Tmax, Hkv, hd],
    bits [B, Tmax] int32) and, with a dense prefix, its own under
    ``dense``."""
    dev = resolve_device(device)
    dtype = T.torch_dtype(cfg) if dtype is None else dtype
    fd = cfg.moe.first_dense_layers
    c = L.init_kv_cache(cfg, batch, max_len, dtype, dev,
                        num_layers=cfg.num_layers - fd)
    c["bits"] = torch.zeros((batch, max_len), dtype=torch.int32, device=dev)
    if fd:
        c["dense"] = L.init_kv_cache(cfg, batch, max_len, dtype, dev,
                                     num_layers=fd)
    return c


def decode_step(model, cfg: ModelConfig, cache, batch):
    """One token a row (``transformer.decode_step`` with the MoE hook).
    The dense prefix runs first on its own cache, as the JAX function's
    does: every row writes at the first row's index and no window
    applies. Updates the cache in place; returns (logits [B,1,V],
    cache)."""
    moe_cfg, ffn = _moe_cfg(cfg), _ffn_hook(cfg)
    if not cfg.moe.first_dense_layers:
        return T.decode_step(model, moe_cfg, cache, batch, ffn=ffn)

    pos, cur, kv_pos, _, allowed = T.decode_mask(cache["bits"], batch)
    x = T.embed_tokens(model, cfg, batch)
    at = cur[:1].expand(cur.shape[0])     # the JAX function's idx = cur[0]
    for i, lp in enumerate(model.dense_layers):
        x = T.decode_layer(cfg, lp, x, pos, kv_pos, allowed[:, None],
                           functools.partial(
                               L.cache_update_ragged, cache["dense"]["k"][i],
                               cache["dense"]["v"][i], index=at))
    # the MoE stack takes the prefix's hidden through inputs_embeds
    moe_batch = dict(batch, inputs_embeds=x,
                     embed_mask=torch.ones(batch["tokens"].shape,
                                           dtype=torch.bool,
                                           device=x.device))
    return T.decode_step(model, moe_cfg, cache, moe_batch, ffn=ffn)
