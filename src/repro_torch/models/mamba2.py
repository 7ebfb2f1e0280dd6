"""Mamba2 (SSD) blocks + the zamba2-style hybrid backbone, the
counterpart of ``repro.models.mamba2``.

Mamba2 (arXiv:2405.21060 semantics; zamba2 arXiv:2411.15242 structure):
state-space recurrence per head

    h_t = a_t · h_{t-1} + dt_t · (B_t ⊗ x_t)        a_t = exp(-exp(A_log)·dt_t)
    y_t = C_t · h_t + D · x_t

Training and prefill use the chunkwise-parallel SSD algorithm: quadratic
attention-like compute within chunks of ``cfg.ssm.chunk`` tokens and a
loop over chunks carrying the inter-chunk state. Decode runs the
recurrence one token at a time (``ssd_step``) with a rolling window of
the depthwise convolution's inputs.

zamba2 hybrid structure: ``num_layers`` Mamba2 blocks; after every
``cfg.attn_layer_period`` blocks one shared full-attention transformer
block (a single weight set, ``shared_attn``, reused at every
application) is applied. Decode keeps one KV strip per shared-block
application plus per-layer SSM and conv states.

The shared block is ``transformer._block``; on the BAM kernel path
(``attn_impl="bam_kernel"``) zamba2's ``head_dim`` 80 runs K1, K2 and
K3 on their wgmma bodies in bf16, padded to 128 in shared memory
(``kernels.bam_attention.kernel_body``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _conv_channels(cfg: ModelConfig) -> int:
    s = cfg.ssm
    return s.d_inner(cfg.d_model) + 2 * s.d_state


class MambaLayer(nn.Module):
    """in_proj [d, z|x|B|C|dt], the depthwise conv over x|B|C, the f32
    decay/skip/dt-bias vectors per head, the gated norm and out_proj."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        di, nh = s.d_inner(d), s.n_heads(d)
        f32 = torch.float32
        self.ln = L.Norm(cfg, d, dtype, device)
        self.in_proj = L.normal_param((d, 2 * di + 2 * s.d_state + nh),
                                      dtype, device, generator)
        self.conv_w = L.normal_param((s.d_conv, _conv_channels(cfg)), dtype,
                                     device, generator)
        self.conv_b = L.const_param((_conv_channels(cfg),), 0.0, dtype,
                                    device)
        self.A_log = L.const_param((nh,), 0.0, f32, device)
        self.D = L.const_param((nh,), 1.0, f32, device)
        self.dt_bias = L.const_param((nh,), 0.0, f32, device)
        self.gate_ln = L.Norm(cfg, di, dtype, device)
        self.out_proj = L.normal_param((di, d), dtype, device, generator)


class HybridLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = T.torch_dtype(cfg)
        self.embed = L.normal_param((cfg.vocab_size, cfg.d_model), dtype,
                                    dev, generator)
        self.layers = nn.ModuleList(
            MambaLayer(cfg, dtype, dev, generator)
            for _ in range(cfg.num_layers))
        self.final_ln = L.Norm(cfg, cfg.d_model, dtype, dev)
        self.shared_attn = T.Block(cfg, dtype, dev, generator) \
            if cfg.attn_layer_period else None
        self.unembed = None if cfg.tie_embeddings else L.normal_param(
            (cfg.d_model, cfg.vocab_size), dtype, dev, generator)


def init(cfg: ModelConfig, *, device="cuda", generator=None) -> HybridLM:
    return HybridLM(cfg, device=device, generator=generator)


# ---------------------------------------------------------------------------
# Core SSD ops
# ---------------------------------------------------------------------------

def _causal_depthwise_conv(x, w, b):
    """x: [B,T,C]; w: [k,C] depthwise causal conv; silu activation."""
    k, T_ = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + T_, :].float() * w[i].float()
    return F.silu(out + b.float()).to(x.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt):
    """z, x, B, C, dt from in_proj's output."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    return torch.split(zxbcdt, [di, di, s.d_state, s.d_state,
                                s.n_heads(cfg.d_model)], dim=-1)


def _dt_decay(p: MambaLayer, dt):
    """(softplus'd dt, log a = -exp(A_log)·dt), f32 [B,T,nh]."""
    dt = F.softplus(dt.float() + p.dt_bias)
    return dt, -torch.exp(p.A_log) * dt


def _ssm_inputs(p: MambaLayer, cfg: ModelConfig, x):
    """Project + conv; returns z, xh [B,T,nh,hd], Bm/Cm [B,T,ds],
    dt [B,T,nh] (softplus'd), a-decay log [B,T,nh]."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    z, xin, Bm, Cm, dt = _split_proj(cfg, x @ p.in_proj)
    conv_out = _causal_depthwise_conv(torch.cat([xin, Bm, Cm], dim=-1),
                                      p.conv_w, p.conv_b)
    xin, Bm, Cm = torch.split(conv_out, [di, s.d_state, s.d_state], dim=-1)
    dt, log_a = _dt_decay(p, dt)
    xh = xin.reshape(*xin.shape[:-1], s.n_heads(cfg.d_model), s.head_dim)
    return z, xh, Bm, Cm, dt, log_a


def ssd_chunked(xh, Bm, Cm, dt, log_a, chunk: int, h0=None):
    """Chunkwise-parallel SSD scan.

    xh: [B,T,nh,hd]; Bm/Cm: [B,T,ds]; dt/log_a: [B,T,nh].
    Returns (y [B,T,nh,hd] f32, h_last [B,nh,hd,ds] f32).
    """
    Bsz, T_, nh, hd = xh.shape
    ds = Bm.shape[-1]
    c = chunk
    if T_ % c:
        raise ValueError(f"sequence length {T_} is not a multiple of the "
                         f"SSD chunk {c}")
    nc = T_ // c
    f32 = torch.float32

    xc = xh.reshape(Bsz, nc, c, nh, hd).to(f32)
    Bc = Bm.reshape(Bsz, nc, c, ds).to(f32)
    Cc = Cm.reshape(Bsz, nc, c, ds).to(f32)
    dtc = dt.reshape(Bsz, nc, c, nh)
    cum = torch.cumsum(log_a.reshape(Bsz, nc, c, nh), dim=2)  # [B,nc,c,nh]

    # intra-chunk: quadratic within the chunk. The decay exp(cum_t - cum_i)
    # is taken on the lower triangle only: above it cum_t - cum_i > 0
    # overflows to inf over a long chunk (128 tokens), and a select after
    # the exp would pass 0 * inf = NaN back to log_a
    cb = torch.einsum("bzts,bzis->bzti", Cc, Bc)            # [B,nc,c,c]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,nc,t,i,nh]
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  -torch.inf))
    m = cb[..., None] * decay * dtc[:, :, None, :, :]       # [B,nc,t,i,nh]
    y_intra = torch.einsum("bztin,bzinh->bztnh", m, xc)

    # chunk summaries: H_z = Σ_i exp(cum_last - cum_i) dt_i (B_i ⊗ x_i)
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dtc        # [B,nc,c,nh]
    Hz = torch.einsum("bzin,bzinh,bzis->bznhs", w_end, xc, Bc)
    Az = torch.exp(cum[:, :, -1, :])                        # [B,nc,nh]

    # inter-chunk state, one chunk at a time: the state before each chunk
    h = torch.zeros((Bsz, nh, hd, ds), dtype=f32, device=xh.device) \
        if h0 is None else h0.to(f32)
    h_prevs = []
    for z in range(nc):
        h_prevs.append(h)
        h = Az[:, z, :, None, None] * h + Hz[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)                   # [B,nc,nh,hd,ds]

    y_inter = torch.einsum("bzts,bznhs->bztnh", Cc, h_prevs) * \
        torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(Bsz, T_, nh, hd), h


def ssd_step(xh, Bm, Cm, dt, log_a, h):
    """Single-token recurrent step. xh: [B,1,nh,hd]; h: [B,nh,hd,ds].
    Returns (y [B,1,nh,hd] f32, new h)."""
    f32 = torch.float32
    a = torch.exp(log_a[:, 0, :]).to(f32)                   # [B,nh]
    u = torch.einsum("bnh,bs,bn->bnhs", xh[:, 0].to(f32), Bm[:, 0].to(f32),
                     dt[:, 0])
    h = a[:, :, None, None] * h + u
    y = torch.einsum("bs,bnhs->bnh", Cm[:, 0].to(f32), h)
    return y[:, None], h


def mamba_block(p: MambaLayer, cfg: ModelConfig, x, *, h0=None,
                conv_state=None, step: bool = False):
    """Full Mamba2 block. Training/prefill: step=False (chunked scan).
    Decode: step=True with (h0, conv_state [B, d_conv-1, C]) from the
    cache. Returns (out, new_h, new_conv_state)."""
    s = cfg.ssm
    res = x
    xn = L.apply_norm(cfg, p.ln, x)
    if step:
        # a rolling window of the last d_conv conv inputs
        di = s.d_inner(cfg.d_model)
        z, xin, Bm, Cm, dt = _split_proj(cfg, xn @ p.in_proj)
        conv_in = torch.cat([xin, Bm, Cm], dim=-1)          # [B,1,C]
        window = torch.cat([conv_state, conv_in], dim=1)    # [B,k,C]
        new_conv_state = window[:, 1:]
        conv_out = torch.sum(window.float() * p.conv_w.float()[None], dim=1,
                             keepdim=True)
        conv_out = F.silu(conv_out + p.conv_b.float()).to(x.dtype)
        xin, Bm, Cm = torch.split(conv_out, [di, s.d_state, s.d_state],
                                  dim=-1)
        dt, log_a = _dt_decay(p, dt)
        xh = xin.reshape(*xin.shape[:-1], s.n_heads(cfg.d_model),
                         s.head_dim)
        y, h_new = ssd_step(xh, Bm, Cm, dt, log_a, h0)
    else:
        z, xh, Bm, Cm, dt, log_a = _ssm_inputs(p, cfg, xn)
        y, h_new = ssd_chunked(xh, Bm, Cm, dt, log_a, s.chunk, h0)
        new_conv_state = None

    y = y + p.D[None, None, :, None] * xh.float()
    y = y.reshape(*y.shape[:-2], -1).to(x.dtype)            # [B,T,di]
    y = L.rmsnorm(y * F.silu(z.float()).to(x.dtype), p.gate_ln.w)
    return res + y @ p.out_proj, h_new, new_conv_state


# ---------------------------------------------------------------------------
# Hybrid backbone (zamba2): groups of mamba layers + shared attention
# ---------------------------------------------------------------------------

def _group_shape(cfg: ModelConfig):
    per = cfg.attn_layer_period
    if not per:
        return 1, cfg.num_layers
    if cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} is not "
                         f"a multiple of attn_layer_period {per}")
    return cfg.num_layers // per, per


def _mamba_out(cfg: ModelConfig, p: MambaLayer, x):
    return mamba_block(p, cfg, x)[0]


def hidden(model: HybridLM, cfg: ModelConfig, batch):
    """(final hidden [B,T,d], {"aux_loss": 0.0})."""
    x = T.embed_tokens(model, cfg, batch)
    n_groups, per = _group_shape(cfg)
    for g in range(n_groups):
        for lp in model.layers[g * per:(g + 1) * per]:
            x = T.remat(cfg, functools.partial(_mamba_out, cfg, lp), x)
        if cfg.attn_layer_period:
            x, _ = T.remat(cfg, functools.partial(
                T._block_out, cfg, model.shared_attn, batch, 0), x)
    return L.apply_norm(cfg, model.final_ln, x), T.aux_dict(0.0, x)


def forward(model: HybridLM, cfg: ModelConfig, batch):
    h, aux = hidden(model, cfg, batch)
    return T.unembed(model, cfg, h), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device="cuda"):
    """ssm [L, B, nh, hd, ds] f32, conv [L, B, d_conv-1, C], bits
    [B, Tmax] int32, and attn_k/attn_v [groups, B, Tmax, Hkv, hd] with a
    shared block."""
    dev = resolve_device(device)
    dtype = T.torch_dtype(cfg) if dtype is None else dtype
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    n_groups, _ = _group_shape(cfg)
    c = {
        "ssm": torch.zeros((cfg.num_layers, batch, nh, s.head_dim,
                            s.d_state), dtype=torch.float32, device=dev),
        "conv": torch.zeros((cfg.num_layers, batch, s.d_conv - 1,
                             _conv_channels(cfg)), dtype=dtype, device=dev),
        "bits": torch.zeros((batch, max_len), dtype=torch.int32, device=dev),
    }
    if cfg.attn_layer_period:
        kv = L.init_kv_cache(cfg, batch, max_len, dtype, dev,
                             num_layers=n_groups)
        c["attn_k"], c["attn_v"] = kv["k"], kv["v"]
    return c


def decode_step(model: HybridLM, cfg: ModelConfig, cache, batch):
    """One token a row. Every row's shared-block K/V goes in at the first
    row's index (the JAX function's ``idx = cur[0]``). Updates the cache
    in place; returns (logits [B,1,V], cache)."""
    pos, cur, kv_pos, q_bits, allowed = T.decode_mask(cache["bits"], batch)
    x = T.embed_tokens(model, cfg, batch)
    n_groups, per = _group_shape(cfg)
    at = cur[:1].expand(cur.shape[0])
    for g in range(n_groups):
        for i in range(g * per, (g + 1) * per):
            x, h_new, cs_new = mamba_block(
                model.layers[i], cfg, x, h0=cache["ssm"][i],
                conv_state=cache["conv"][i], step=True)
            cache["ssm"][i] = h_new
            cache["conv"][i] = cs_new
        if cfg.attn_layer_period:
            x = T.decode_layer(cfg, model.shared_attn, x, pos, kv_pos,
                               allowed[:, None], functools.partial(
                                   L.cache_update_ragged, cache["attn_k"][g],
                                   cache["attn_v"][g], index=at))
    return T.decode_logits(model, cfg, cache, x, cur, q_bits), cache
