"""Dense decoder-only transformer family (port of
``repro.models.transformer``).

``TransformerLM`` holds the parameters (an ``nn.ModuleList`` of
``Block``s, one per layer); the functions below take it with the config,
as the JAX package's functions take (params, cfg). One set of weights can
so run under configs that differ only in ``attn_impl``.

Covers (via ModelConfig flags) starcoder2-7b (layernorm, gelu, QKV
bias), qwen3-1.7b (qk_norm), gemma2-9b (local/global alternation,
softcaps, post-block norms, tied embeddings, embed scale), qwen2.5-14b
(QKV bias) and the qwen2-vl-7b language backbone (M-RoPE via cfg.mm,
``models.vlm``).

batch keys: tokens [B,T] int; positions [B,T] int32; optional bits
[B,T] int32 (BAM; None => causal); optional inputs_embeds [B,T,d] +
embed_mask [B,T] bool (multimodal merge); optional pos3 [3,B,T] int32
(M-RoPE).

``init_cache`` and ``decode_step`` decode one token a row against a
[L, B, Tmax] strip cache, as the JAX package's; the paged cache
(``repro_torch.serving``) is the port's other decode path.

The MoE family (``models.moe``) and the hybrid's shared attention block
(``models.mamba2``) reuse this skeleton: ``init``'s ``ffn_init`` builds
another FFN module under ``mlp``, and ``_block``, ``run_layers`` and
``decode_step`` take an ``ffn(layer, h, layer_idx) -> (out, aux)`` hook
whose aux (the router's load-balance loss) ``run_layers`` sums over
layers and ``hidden`` returns as ``{"aux_loss": ...}``.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bam
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator,
                 ffn_init=None):
        super().__init__()
        gated = cfg.act == "silu" or cfg.name.startswith("gemma2")
        self.ln1 = L.Norm(cfg, cfg.d_model, dtype, device)
        self.attn = L.Attention(cfg, dtype, device, generator)
        self.ln2 = L.Norm(cfg, cfg.d_model, dtype, device)
        if ffn_init is None:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype, device,
                             generator, gated)
        else:
            self.mlp = ffn_init(dtype, device, generator)
        if cfg.post_block_norm:
            self.post_ln1 = L.Norm(cfg, cfg.d_model, dtype, device)
            self.post_ln2 = L.Norm(cfg, cfg.d_model, dtype, device)


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", generator=None,
                 ffn_init=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg)
        self.embed = L.normal_param((cfg.vocab_size, cfg.d_model), dtype,
                                    dev, generator)
        self.layers = nn.ModuleList(
            Block(cfg, dtype, dev, generator, ffn_init)
            for _ in range(cfg.num_layers))
        self.final_ln = L.Norm(cfg, cfg.d_model, dtype, dev)
        self.unembed = None if cfg.tie_embeddings else L.normal_param(
            (cfg.d_model, cfg.vocab_size), dtype, dev, generator)


def init(cfg: ModelConfig, *, device="cuda", generator=None,
         ffn_init=None) -> TransformerLM:
    """Random weights (normal × 0.02 for matrices, as the JAX init) on
    ``device``, drawn from ``generator`` (on the same device).
    ``ffn_init(dtype, device, generator)``, if given, builds each
    layer's ``mlp`` module in place of the dense MLP."""
    return TransformerLM(cfg, device=device, generator=generator,
                         ffn_init=ffn_init)


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------

def layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    """gemma2 alternation: every cfg.local_global_pattern-th layer is
    global, others use cfg.sliding_window."""
    if cfg.local_global_pattern:
        is_global = (layer_idx % cfg.local_global_pattern) == (
            cfg.local_global_pattern - 1)
        return 0 if is_global else cfg.sliding_window
    return cfg.sliding_window


def _mask_for(batch, window: int, q_slice=None):
    """[B,1,Tq,T] bool mask; the window constrains text queries only.
    ``q_slice=(start, size)`` builds just that block of query rows (the
    q-chunked path); else Tq = T."""
    pos = batch["positions"]
    bits = batch.get("bits")
    q_pos, q_bits = pos, bits
    if q_slice is not None:
        start, size = q_slice
        q_pos = pos[:, start:start + size]
        if bits is not None:
            q_bits = bits[:, start:start + size]
    win_ok = (q_pos[:, :, None] - pos[:, None, :]) < window if window \
        else torch.ones((), dtype=torch.bool, device=pos.device)
    if bits is not None:
        m = bam.allowed_mask(q_bits, bits, q_pos, pos)
        q_text = bam.own_modality(q_bits[:, :, None]) == bam.TEXT
        return (m & (win_ok | ~q_text))[:, None]
    m = pos[:, None, :] <= q_pos[:, :, None]
    return (m & win_ok)[:, None]


def _default_ffn(lp: Block, h, cfg: ModelConfig):
    """The dense MLP: (out, aux) with aux 0 (no router)."""
    return L.run_mlp(lp.mlp, h, cfg.act), 0.0


def _block(cfg: ModelConfig, p: Block, x, batch, layer_idx: int, ffn=None):
    """One layer. Returns (x, aux, (k, v)): aux the FFN's (0.0 for the
    dense MLP), k/v the layer's projected, roped K/V (kept by the serving
    prefill). ``ffn(p, h, layer_idx) -> (out, aux)`` replaces the dense
    MLP."""
    window = layer_window(cfg, layer_idx)
    # context parallelism takes the layer's own static window, so
    # gemma2's local/global alternation stays context parallel and exact
    # (a rank holds only its run of the sequence: plain attention there
    # would see that run alone). Off CP the BAM kernel takes one window
    # for the model, and the alternation stays on the plain path, as in
    # JAX.
    bits = batch.get("bits")
    use_bits = bits is not None and (
        cfg.cp_mesh is not None
        or (cfg.attn_impl != "xla" and not cfg.local_global_pattern))

    h = L.apply_norm(cfg, p.ln1, x)
    attn_out, kv = L.run_attention(
        p.attn, cfg, h, q_pos=batch["positions"],
        mask_fn=lambda start, size: _mask_for(batch, window, (start, size)),
        pos3=batch.get("pos3"), bits=bits if use_bits else None,
        window=window if use_bits else 0)
    if cfg.post_block_norm:
        attn_out = L.apply_norm(cfg, p.post_ln1, attn_out)
    x = x + attn_out
    h = L.apply_norm(cfg, p.ln2, x)
    if ffn is None:
        mlp_out, aux = _default_ffn(p, h, cfg)
    else:
        mlp_out, aux = ffn(p, h, layer_idx)
    if cfg.post_block_norm:
        mlp_out = L.apply_norm(cfg, p.post_ln2, mlp_out)
    return x + mlp_out, aux, kv


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_tokens(model: TransformerLM, cfg: ModelConfig, batch):
    x = model.embed[batch["tokens"].long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if batch.get("inputs_embeds") is not None:
        x = torch.where(batch["embed_mask"][..., None],
                        batch["inputs_embeds"].to(x.dtype), x)
    return x


def _block_out(cfg: ModelConfig, p: Block, batch, layer_idx: int, x,
               ffn=None):
    """(x, aux) of one layer, x last so that ``remat`` can bind the
    rest."""
    x, aux, _ = _block(cfg, p, x, batch, layer_idx, ffn)
    return x, aux


def remat(cfg: ModelConfig, fn, x):
    """fn(x), rematerialised when ``cfg.remat`` is set and autograd is
    recording: only x is kept, and the backward re-runs fn (non-reentrant
    ``torch.utils.checkpoint``), as ``jax.checkpoint`` does in the JAX
    package. Without grad, as in serving or a frozen encoder under
    ``no_grad``, fn just runs."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def run_layers(cfg: ModelConfig, layers, batch, x, ffn=None):
    """x through ``layers`` (layer i with index i), each under ``remat``.
    Returns (x, aux summed over the layers)."""
    aux = 0.0
    for i, lp in enumerate(layers):
        # partial binds this layer: the recompute runs after the loop
        x, a = remat(cfg, functools.partial(_block_out, cfg, lp, batch, i,
                                            ffn=ffn), x)
        aux = aux + a
    return x, aux


def aux_dict(aux, like) -> dict:
    """``{"aux_loss": aux}`` as a 0-dim f32 tensor on ``like``'s device
    (an exact 0.0 where no layer has a router)."""
    if not isinstance(aux, torch.Tensor):
        aux = torch.tensor(aux, dtype=torch.float32, device=like.device)
    return {"aux_loss": aux}


def hidden(model: TransformerLM, cfg: ModelConfig, batch):
    """(final hidden [B,T,d], {"aux_loss": ...}) like the JAX function."""
    x = embed_tokens(model, cfg, batch)
    x, aux = run_layers(cfg, model.layers, batch, x)
    return L.apply_norm(cfg, model.final_ln, x), aux_dict(aux, x)


def unembed(model: TransformerLM, cfg: ModelConfig, h):
    w = model.embed.T if cfg.tie_embeddings else model.unembed
    logits = h @ w
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def forward(model: TransformerLM, cfg: ModelConfig, batch):
    """Returns (logits [B,T,V], aux dict) like the JAX forward."""
    h, aux = hidden(model, cfg, batch)
    return unembed(model, cfg, h), aux


def _cache_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config whose KV head count the decode cache holds
    (``decode_kv_replicate`` widens it)."""
    if cfg.decode_kv_replicate > cfg.num_kv_heads:
        if (cfg.num_heads % cfg.decode_kv_replicate != 0
                or cfg.decode_kv_replicate % cfg.num_kv_heads != 0):
            raise ValueError(
                f"{cfg.name}: decode_kv_replicate="
                f"{cfg.decode_kv_replicate} must divide num_heads="
                f"{cfg.num_heads} and be a multiple of num_kv_heads="
                f"{cfg.num_kv_heads}")
        return cfg.replace(num_kv_heads=cfg.decode_kv_replicate,
                           decode_kv_replicate=0)
    return cfg


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device="cuda"):
    """Empty strip cache on ``device``: k/v [L, B, Tmax, Hkv, hd] (Hkv
    widened by ``decode_kv_replicate``) in ``dtype`` (default cfg's),
    bits [B, Tmax] int32."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg) if dtype is None else dtype
    c = L.init_kv_cache(_cache_cfg(cfg), batch, max_len, dtype, dev)
    c["bits"] = torch.zeros((batch, max_len), dtype=torch.int32, device=dev)
    return c


def decode_mask(cache_bits, batch):
    """The strip-cache decode's prelude, shared by every family: (pos
    [B,1], cur [B] (each row's cache index), kv_pos [B,Tmax], q_bits
    [B,1] (text when the batch has none), allowed [B,1,Tmax]). Row b's
    query sees the cache's bits below cur[b], its own at cur[b] and
    nothing above."""
    B, Tmax = cache_bits.shape
    pos = batch["positions"]
    cur = pos[:, 0].long()
    kv_pos = torch.arange(Tmax, dtype=torch.int32,
                          device=pos.device)[None].expand(B, Tmax)
    q_bits = batch.get("bits")
    if q_bits is None:
        q_bits = torch.full((B, 1), bam.text_token(), dtype=torch.int32,
                            device=pos.device)
    bits = torch.where(
        kv_pos < cur[:, None], cache_bits,
        torch.where(kv_pos == cur[:, None], q_bits.expand(B, Tmax),
                    torch.zeros_like(cache_bits)))
    return pos, cur, kv_pos, q_bits, bam.allowed_mask(q_bits, bits, pos,
                                                      kv_pos)


def decode_layer(cfg: ModelConfig, lp: Block, x, pos, kv_pos, mask,
                 kv_override, pos3=None, ffn=None, layer_idx: int = 0):
    """``_block`` on one token a row: attention against the strip cache
    (``kv_override`` writes the new K/V and returns the strips) under
    ``mask`` [B,1,1,Tmax], then the FFN (``ffn`` as ``_block``'s)."""
    h = L.apply_norm(cfg, lp.ln1, x)
    attn_out, _ = L.run_attention(lp.attn, cfg, h, q_pos=pos, kv_pos=kv_pos,
                                  mask=mask, pos3=pos3,
                                  kv_override=kv_override)
    if cfg.post_block_norm:
        attn_out = L.apply_norm(cfg, lp.post_ln1, attn_out)
    x = x + attn_out
    h = L.apply_norm(cfg, lp.ln2, x)
    mlp_out, _ = _default_ffn(lp, h, cfg) if ffn is None \
        else ffn(lp, h, layer_idx)
    if cfg.post_block_norm:
        mlp_out = L.apply_norm(cfg, lp.post_ln2, mlp_out)
    return x + mlp_out


def decode_logits(model, cfg: ModelConfig, cache, x, cur, q_bits):
    """The decode step's tail: logits [B,1,V] of the last hidden, and the
    query's bits written into the cache at each row's index."""
    logits = unembed(model, cfg, L.apply_norm(cfg, model.final_ln, x))
    cache["bits"][torch.arange(x.shape[0], device=x.device), cur] = \
        q_bits[:, 0]
    return logits


def decode_step(model: TransformerLM, cfg: ModelConfig, cache, batch,
                ffn=None):
    """One token a row at ragged offsets. batch: tokens [B,1], positions
    [B,1] (= each row's cache index), optional bits [B,1] (text by
    default) and pos3 [3,B,1]. cache: {k, v: [L,B,Tmax,Hkv,hd], bits:
    [B,Tmax]}. Each row writes its new K/V at its own index and attends
    the cache below it and itself, under each layer's window. Updates
    the cache's tensors in place (the JAX function returns a new cache)
    and returns (logits [B,1,V], cache). ``ffn`` as ``_block``'s."""
    pos, cur, kv_pos, q_bits, allowed = decode_mask(cache["bits"], batch)
    x = embed_tokens(model, cfg, batch)
    masks = {}
    for i, lp in enumerate(model.layers):
        window = layer_window(cfg, i)
        if window not in masks:
            win_ok = (pos[:, :, None] - kv_pos[:, None, :]) < window \
                if window else True
            masks[window] = (allowed & win_ok)[:, None]

        def kv_override(k, v, i=i):
            rep = cfg.decode_kv_replicate
            if rep > k.shape[2]:
                k = bam.repeat_kv(k, rep // k.shape[2])
                v = bam.repeat_kv(v, rep // v.shape[2])
            return L.cache_update_ragged(cache["k"][i], cache["v"][i], k, v,
                                         cur)

        x = decode_layer(cfg, lp, x, pos, kv_pos, masks[window], kv_override,
                         pos3=batch.get("pos3"), ffn=ffn, layer_idx=i)
    return decode_logits(model, cfg, cache, x, cur, q_bits), cache
