"""Whisper-style encoder-decoder audio backbone (arXiv:2212.04356), the
counterpart of ``repro.models.whisper``.

The mel-spectrogram + 2×conv frontend is stubbed: the batch carries
precomputed frame embeddings ``encoder_embeds [B, n_frames, d_model]``
(cast to the model's dtype), which go straight to the encoder.

Encoder: bidirectional MHA + gelu MLP, sinusoidal positions, pre-LN.
Decoder: self-attention (causal, or BAM's rule when the batch has bits)
+ cross-attention to the encoder's states. As in the reference, the
decoder uses sinusoidal positions instead of Whisper's learned
448-entry table, and the unembedding is tied to the embedding. There is
no ``hidden``: losses and the prefill take the forward's logits.

Attention is the plain masked path of ``layers.run_attention``; no bits
reach the BAM kernel, as none reach the reference's Pallas kernel.
Under context parallelism (``cfg.cp_mesh``) the decoder's
self-attention goes through ``cp_attention`` with the batch's bits
(each rank holds its own run of the permuted decoder tokens), while
every rank runs the encoder over all frames, so cross-attention needs
no collective.

Decode keeps a [L, B, Tmax] self-attention strip cache plus each
layer's cross K/V over the encoder frames (``prefill_cross``).
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bam
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def sinusoid_pos(pos, d: int):
    """pos: [B,T] -> [B,T,d] float32 sinusoidal embedding."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=pos.device) / half)
    ang = pos.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class DecoderLayer(T.Block):
    """An encoder layer (``T.Block``: ln1, attn, ln2, the ungated gelu
    MLP) plus the cross-attention and its norm."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__(cfg, dtype, device, generator)
        self.ln_cross = L.Norm(cfg, cfg.d_model, dtype, device)
        self.cross = L.Attention(cfg, dtype, device, generator)


class WhisperLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = T.torch_dtype(cfg)
        self.embed = L.normal_param((cfg.vocab_size, cfg.d_model), dtype,
                                    dev, generator)
        self.enc_layers = nn.ModuleList(
            T.Block(cfg, dtype, dev, generator)
            for _ in range(cfg.encdec.num_encoder_layers))
        self.enc_ln = L.Norm(cfg, cfg.d_model, dtype, dev)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, dev, generator)
            for _ in range(cfg.num_layers))
        self.final_ln = L.Norm(cfg, cfg.d_model, dtype, dev)


def init(cfg: ModelConfig, *, device="cuda", generator=None) -> WhisperLM:
    return WhisperLM(cfg, device=device, generator=generator)


def _positions(B: int, T_: int, device):
    return torch.arange(T_, dtype=torch.int32, device=device)[None].expand(
        B, T_)


def _all_keys(Te: int, device):
    """The cross-attention's (and the encoder's) mask: every key."""
    return torch.ones((1, 1, 1, Te), dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _enc_block(cfg: ModelConfig, lp: T.Block, pos, x):
    h = L.apply_norm(cfg, lp.ln1, x)
    a, _ = L.run_attention(lp.attn, cfg, h, q_pos=pos,
                           mask=_all_keys(x.shape[1], x.device), rope=False)
    x = x + a
    h = L.apply_norm(cfg, lp.ln2, x)
    return x + L.run_mlp(lp.mlp, h, "gelu")


def encode(model: WhisperLM, cfg: ModelConfig, frames):
    """frames: [B, T_enc, d], the stubbed conv frontend's output."""
    B, Te, _ = frames.shape
    pos = _positions(B, Te, frames.device)
    x = frames.to(model.embed.dtype)
    x = x + sinusoid_pos(pos, cfg.d_model).to(x.dtype)
    for lp in model.enc_layers:
        x = T.remat(cfg, functools.partial(_enc_block, cfg, lp, pos), x)
    return L.apply_norm(cfg, model.enc_ln, x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _dec_block(cfg: ModelConfig, lp: DecoderLayer, enc_out, batch,
               self_mask, x):
    """One decoder layer; x last so that ``remat`` can bind the rest.
    ``self_mask`` is None under CP, where the bits go to
    ``cp_attention``."""
    q_pos = batch["positions"]
    h = L.apply_norm(cfg, lp.ln1, x)
    a, _ = L.run_attention(
        lp.attn, cfg, h, q_pos=q_pos, mask=self_mask, rope=False,
        bits=batch["bits"] if self_mask is None else None)
    x = x + a
    h = L.apply_norm(cfg, lp.ln_cross, x)
    B, Te = enc_out.shape[:2]
    a, _ = L.run_attention(lp.cross, cfg, h, x_kv=enc_out, q_pos=q_pos,
                           kv_pos=_positions(B, Te, x.device),
                           mask=_all_keys(Te, x.device), rope=False)
    x = x + a
    h = L.apply_norm(cfg, lp.ln2, x)
    return x + L.run_mlp(lp.mlp, h, "gelu")


def _embed(model: WhisperLM, cfg: ModelConfig, tokens, positions):
    x = model.embed[tokens.long()]
    return x + sinusoid_pos(positions, cfg.d_model).to(x.dtype)


def forward(model: WhisperLM, cfg: ModelConfig, batch):
    """batch: encoder_embeds [B,Te,d]; tokens/positions [B,T]; optional
    bits [B,T] (BAM over the decoder tokens; required under CP).
    Returns (logits [B,T,V], {"aux_loss": 0.0})."""
    enc_out = encode(model, cfg, batch["encoder_embeds"])
    q_pos = batch["positions"]
    x = _embed(model, cfg, batch["tokens"], q_pos)
    bits = batch.get("bits")
    if cfg.cp_mesh is not None:
        if bits is None:
            # without bits each rank would attend over its own run alone
            raise ValueError("whisper under context parallelism needs "
                             "batch['bits'] for the decoder's "
                             "self-attention")
        self_mask = None
    elif bits is not None:
        self_mask = bam.allowed_mask(bits, bits, q_pos, q_pos)[:, None]
    else:
        self_mask = L.causal_mask(q_pos, q_pos)
    for lp in model.layers:
        x = T.remat(cfg, functools.partial(_dec_block, cfg, lp, enc_out,
                                           batch, self_mask), x)
    h = L.apply_norm(cfg, model.final_ln, x)
    return h @ model.embed.T, T.aux_dict(0.0, x)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device="cuda"):
    """k/v [L, B, Tmax, Hkv, hd], bits [B, Tmax] int32 (kept for the
    reference's layout; the decoder does not read it), and cross_k/cross_v
    [L, B, encoder_seq, Hkv, hd] (filled by ``prefill_cross``)."""
    dev = resolve_device(device)
    dtype = T.torch_dtype(cfg) if dtype is None else dtype
    c = L.init_kv_cache(cfg, batch, max_len, dtype, dev)
    c["bits"] = torch.zeros((batch, max_len), dtype=torch.int32, device=dev)
    shape = (cfg.num_layers, batch, cfg.encdec.encoder_seq,
             cfg.num_kv_heads, cfg.head_dim)
    c["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
    c["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return c


def prefill_cross(model: WhisperLM, cfg: ModelConfig, cache, frames):
    """Run the encoder once and fill every layer's cross K/V (projected
    without the k/v biases, as the reference does). Returns a new cache
    dict holding the new cross tensors."""
    enc_out = encode(model, cfg, frames)
    B, Te = enc_out.shape[:2]

    def heads(w):
        return (enc_out @ w).reshape(B, Te, cfg.num_kv_heads, cfg.head_dim)
    cache = dict(cache)
    cache["cross_k"] = torch.stack([heads(lp.cross.wk) for lp in model.layers])
    cache["cross_v"] = torch.stack([heads(lp.cross.wv) for lp in model.layers])
    return cache


def decode_step(model: WhisperLM, cfg: ModelConfig, cache, batch):
    """One token a row (tokens/positions [B,1]). Every row's self K/V goes
    in at the first row's position (the JAX function's ``idx =
    cur[0]``); each row attends the strip up to its own position and all
    the cross K/V. Updates the self strips in place and returns (logits
    [B,1,V], cache)."""
    pos = batch["positions"]
    B, Tmax = pos.shape[0], cache["k"].shape[2]
    cur = pos[:, 0].long()
    at = cur[:1].expand(B)
    kv_pos = _positions(B, Tmax, pos.device)
    self_mask = (kv_pos <= cur[:, None])[:, None, None, :]
    Te = cache["cross_k"].shape[2]
    enc_pos, cross_mask = _positions(B, Te, pos.device), _all_keys(Te,
                                                                  pos.device)
    x = _embed(model, cfg, batch["tokens"], pos)
    for i, lp in enumerate(model.layers):
        h = L.apply_norm(cfg, lp.ln1, x)
        a, _ = L.run_attention(
            lp.attn, cfg, h, q_pos=pos, kv_pos=kv_pos, mask=self_mask,
            rope=False, kv_override=functools.partial(
                L.cache_update_ragged, cache["k"][i], cache["v"][i],
                index=at))
        x = x + a
        h = L.apply_norm(cfg, lp.ln_cross, x)
        a, _ = L.run_attention(
            lp.cross, cfg, h, q_pos=pos, kv_pos=enc_pos, mask=cross_mask,
            rope=False, kv_override=lambda k, v, i=i: (cache["cross_k"][i],
                                                       cache["cross_v"][i]))
        x = x + a
        h = L.apply_norm(cfg, lp.ln2, x)
        x = x + L.run_mlp(lp.mlp, h, "gelu")
    h = L.apply_norm(cfg, model.final_ln, x)
    return h @ model.embed.T, cache
