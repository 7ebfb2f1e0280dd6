"""xLSTM backbone (arXiv:2405.04517): mLSTM + sLSTM blocks, the
counterpart of ``repro.models.xlstm``.

* **mLSTM**: matrix-memory LSTM with exponential gating. Training and
  prefill use the stabilized parallel form (``mlstm_parallel``), or,
  when T is a multiple of ``cfg.xlstm.chunk`` longer than one chunk, the
  chunkwise-parallel form (``mlstm_chunked``: quadratic within a chunk,
  the (C, n, m) state carried across chunks by a loop). Decode runs the
  recurrence one token at a time (``mlstm_step``) with per-head state
  C [hd, hd], n [hd], m and a rolling window of the depthwise
  convolution's inputs.
* **sLSTM**: scalar-memory LSTM with exponential gating and
  block-diagonal recurrent weights; training runs a loop over time
  (sequential by construction, the paper's own formulation).

``cfg.xlstm.slstm_at`` selects the sLSTM blocks, the rest are mLSTM.
The heads of the mLSTM are ``d_model * proj_factor_m / num_heads`` wide
(``_dims``); ``cfg.head_dim`` is not used. Blocks carry their own
up/down projections (``d_ff`` is 0). No attention, and no kernel: every
op here is a plain torch op.
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
from repro_torch.models.mamba2 import _causal_depthwise_conv

#: the chunked form's "no state yet" stabilizer (finite, unlike -inf)
NEG = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    """(d, dm, nh, hd) of the mLSTM: dm = d * proj_factor_m, hd = dm / nh."""
    d = cfg.d_model
    dm = int(d * cfg.xlstm.proj_factor_m)
    nh = cfg.num_heads
    return d, dm, nh, dm // nh


class MLSTMLayer(nn.Module):
    """up / gate-up projections, the depthwise conv, q/k/v, the input and
    forget gates (f32 forget bias 3: open gates), the head norm and the
    down projection."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d, dm, nh, _ = _dims(cfg)
        self.ln = L.Norm(cfg, d, dtype, device)
        self.w_up = L.normal_param((d, dm), dtype, device, generator)
        self.w_gate_up = L.normal_param((d, dm), dtype, device, generator)
        self.conv_w = L.normal_param((cfg.xlstm.conv_kernel, dm), dtype,
                                     device, generator)
        self.conv_b = L.const_param((dm,), 0.0, dtype, device)
        self.wq = L.normal_param((dm, dm), dtype, device, generator)
        self.wk = L.normal_param((dm, dm), dtype, device, generator)
        self.wv = L.normal_param((dm, dm), dtype, device, generator)
        self.wi = L.normal_param((dm, nh), dtype, device, generator)
        self.wf = L.normal_param((dm, nh), dtype, device, generator)
        self.f_bias = L.const_param((nh,), 3.0, torch.float32, device)
        self.head_ln = L.Norm(cfg, dm, dtype, device)
        self.w_down = L.normal_param((dm, d), dtype, device, generator)


class SLSTMLayer(nn.Module):
    """The depthwise conv, z/i/f/o input weights [d, 4d], block-diagonal
    recurrent weights [4, nh, hd, hd] (hd = d / nh), f32 biases [4, d],
    the group norm and a gated gelu FFN of d * proj_factor_s."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d, nh = cfg.d_model, cfg.num_heads
        x = cfg.xlstm
        self.ln = L.Norm(cfg, d, dtype, device)
        self.conv_w = L.normal_param((x.conv_kernel, d), dtype, device,
                                     generator)
        self.conv_b = L.const_param((d,), 0.0, dtype, device)
        self.w_zifo = L.normal_param((d, 4 * d), dtype, device, generator)
        self.r_zifo = L.normal_param((4, nh, d // nh, d // nh), dtype,
                                     device, generator)
        self.b_zifo = L.const_param((4, d), 0.0, torch.float32, device)
        self.group_ln = L.Norm(cfg, d, dtype, device)
        self.ffn = L.MLP(d, int(d * x.proj_factor_s), dtype, device,
                         generator, gated=True)
        self.ffn_ln = L.Norm(cfg, d, dtype, device)


def _counts(cfg: ModelConfig):
    """(mLSTM layers, sLSTM layers)."""
    n_s = len(cfg.xlstm.slstm_at)
    return cfg.num_layers - n_s, n_s


class XLSTMLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = T.torch_dtype(cfg)
        n_m, n_s = _counts(cfg)
        self.embed = L.normal_param((cfg.vocab_size, cfg.d_model), dtype,
                                    dev, generator)
        # the reference keeps one (unused) mLSTM layer when every layer
        # is sLSTM
        self.mlstm_layers = nn.ModuleList(
            MLSTMLayer(cfg, dtype, dev, generator) for _ in range(max(n_m, 1)))
        self.final_ln = L.Norm(cfg, cfg.d_model, dtype, dev)
        self.slstm_layers = nn.ModuleList(
            SLSTMLayer(cfg, dtype, dev, generator) for _ in range(n_s))
        self.unembed = None if cfg.tie_embeddings else L.normal_param(
            (cfg.d_model, cfg.vocab_size), dtype, dev, generator)


def init(cfg: ModelConfig, *, device="cuda", generator=None) -> XLSTMLM:
    return XLSTMLM(cfg, device=device, generator=generator)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_qkvif(p: MLSTMLayer, cfg: ModelConfig, xn):
    """q (scaled by hd^-0.5), k, v [B,T,nh,hd]; log input gate and log
    forget gate [B,T,nh] f32; output gate [B,T,dm] f32; xu."""
    _, _, nh, hd = _dims(cfg)
    xu = xn @ p.w_up
    xg = xn @ p.w_gate_up                                 # output-gate branch
    xc = _causal_depthwise_conv(xu, p.conv_w, p.conv_b)
    B_, T_ = xn.shape[:2]

    def heads(a):
        return a.reshape(B_, T_, nh, hd)
    q = heads(xc @ p.wq) * (hd ** -0.5)
    k = heads(xc @ p.wk)
    v = heads(xu @ p.wv)
    log_i = (xc @ p.wi).float()
    log_f = F.logsigmoid((xc @ p.wf).float() + p.f_bias)  # <= 0
    o_gate = torch.sigmoid(xg.float())
    return q, k, v, log_i, log_f, o_gate, xu


def mlstm_parallel(q, k, v, log_i, log_f):
    """Stabilized parallel mLSTM (paper eq. 19-27). q/k/v [B,T,nh,hd],
    gates [B,T,nh]; returns h [B,T,nh,hd] f32."""
    fcum = torch.cumsum(log_f, dim=1)                              # [B,T,nh]
    # dtilde[t,s] = fcum[t] - fcum[s] + log_i[s], s <= t
    dt_mat = fcum[:, :, None, :] - fcum[:, None, :, :] + log_i[:, None, :, :]
    T_ = q.shape[1]
    tri = torch.tril(torch.ones((T_, T_), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    dt_mat = torch.where(tri, dt_mat, float("-inf"))
    m = dt_mat.amax(dim=2, keepdim=True)                           # [B,t,1,nh]
    D = torch.exp(dt_mat - m)
    S = torch.einsum("btnh,bsnh->btsn", q.float(), k.float()) * D
    norm = torch.maximum(S.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    return torch.einsum("btsn,bsnh->btnh", S / norm, v.float())


def mlstm_chunked(q, k, v, log_i, log_f, chunk: int, state=None):
    """Chunkwise-parallel stabilized mLSTM: quadratic within chunks of
    ``chunk`` tokens, the recurrent (C, n, m) state carried across them.
    Equals ``mlstm_parallel`` (the oracle) to float tolerance in O(T·c)
    memory. Returns (h [B,T,nh,hd] f32, (C [B,nh,hd,hd], n [B,nh,hd],
    m [B,nh]) after the last chunk)."""
    B_, T_, nh, hd = q.shape
    c = min(chunk, T_)
    if T_ % c:
        raise ValueError(f"sequence length {T_} is not a multiple of the "
                         f"mLSTM chunk {c}")
    dev, f32 = q.device, torch.float32
    qf, kf, vf = q.float(), k.float(), v.float()
    if state is None:
        C = torch.zeros((B_, nh, hd, hd), dtype=f32, device=dev)
        n = torch.zeros((B_, nh, hd), dtype=f32, device=dev)
        m = torch.full((B_, nh), NEG, dtype=f32, device=dev)
    else:
        C, n, m = state
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=dev))[None, :, :, None]
    hs = []
    for s in range(0, T_, c):
        qz, kz, vz = qf[:, s:s + c], kf[:, s:s + c], vf[:, s:s + c]
        li, lf = log_i[:, s:s + c], log_f[:, s:s + c]          # [B,c,nh]
        fcum = torch.cumsum(lf, dim=1)
        # local matrix exponents dt[t,s] = fcum_t - fcum_s + li_s
        dt_mat = fcum[:, :, None, :] - fcum[:, None, :, :] + li[:, None]
        dt_mat = torch.where(tril, dt_mat, NEG)
        local_max = dt_mat.amax(dim=2)                          # [B,c,nh]
        m_inter = m[:, None, :] + fcum
        m_t = torch.maximum(m_inter, local_max)
        # intra-chunk terms; the normalizer uses the plain decay weights
        w_dec = torch.exp(dt_mat - m_t[:, :, None, :])          # [B,t,s,nh]
        S = torch.einsum("btnh,bsnh->btsn", qz, kz) * w_dec
        h_num = torch.einsum("btsn,bsnd->btnd", S, vz)
        n_vec = torch.einsum("btsn,bsnh->btnh", w_dec, kz)
        # inter-chunk terms from the carried state
        scale = torch.exp(m_inter - m_t)[..., None]             # [B,c,nh,1]
        h_num = h_num + scale * torch.einsum("btnh,bnhd->btnd", qz, C)
        n_vec = n_vec + scale * n[:, None]
        denom = torch.maximum((n_vec * qz).sum(dim=-1, keepdim=True).abs(),
                              torch.exp(-m_t)[..., None])
        hs.append(h_num / denom)
        # the state at the end of the chunk
        w_end = fcum[:, -1:, :] - fcum + li                     # [B,c,nh]
        m_end_inter = m + fcum[:, -1]
        m_new = torch.maximum(m_end_inter, w_end.amax(dim=1))
        we = torch.exp(w_end - m_new[:, None, :])
        decay = torch.exp(m_end_inter - m_new)
        C = decay[:, :, None, None] * C + torch.einsum(
            "bsn,bsnh,bsnd->bnhd", we, kz, vz)
        n = decay[:, :, None] * n + torch.einsum("bsn,bsnh->bnh", we, kz)
        m = m_new
    return torch.cat(hs, dim=1), (C, n, m)


def mlstm_block(p: MLSTMLayer, cfg: ModelConfig, x):
    """The residual mLSTM block: chunked when T is a multiple of the
    chunk longer than one chunk, else parallel."""
    _, dm, _, _ = _dims(cfg)
    xn = L.apply_norm(cfg, p.ln, x)
    q, k, v, log_i, log_f, o_gate, _ = _mlstm_qkvif(p, cfg, xn)
    T_, chunk = q.shape[1], cfg.xlstm.chunk
    if T_ % chunk == 0 and T_ > chunk:
        h, _ = mlstm_chunked(q, k, v, log_i, log_f, chunk)
    else:
        h = mlstm_parallel(q, k, v, log_i, log_f)
    h = h.reshape(*h.shape[:-2], dm)
    h = L.rmsnorm(h.to(x.dtype), p.head_ln.w)
    h = (h.float() * o_gate).to(x.dtype)
    return x + h @ p.w_down


def _conv_step(window, w, b, dtype):
    """The depthwise conv's output at the window's last position, silu'd."""
    xc = torch.sum(window.float() * w.float()[None], dim=1, keepdim=True)
    return F.silu(xc + b.float()).to(dtype)


def mlstm_step(p: MLSTMLayer, cfg: ModelConfig, x, state):
    """Recurrent decode step of x [B,1,d]. state: (C [B,nh,hd,hd],
    n [B,nh,hd], m [B,nh], conv [B,k-1,dm]). Returns (x, new state)."""
    _, dm, nh, hd = _dims(cfg)
    C, n, m, conv = state
    xn = L.apply_norm(cfg, p.ln, x)
    xu = xn @ p.w_up                                          # [B,1,dm]
    xg = xn @ p.w_gate_up
    window = torch.cat([conv, xu], dim=1)                     # [B,k,dm]
    xc = _conv_step(window, p.conv_w, p.conv_b, x.dtype)

    def heads(a):
        return a[:, 0].reshape(a.shape[0], nh, hd)
    q = heads(xc @ p.wq) * (hd ** -0.5)
    k = heads(xc @ p.wk).float()
    v = heads(xu @ p.wv).float()
    log_i = (xc @ p.wi)[:, 0].float()                         # [B,nh]
    log_f = F.logsigmoid((xc @ p.wf)[:, 0].float() + p.f_bias)
    m_new = torch.maximum(log_f + m, log_i)
    a = torch.exp(log_f + m - m_new)[:, :, None]
    b = torch.exp(log_i - m_new)[:, :, None]
    C = a[..., None] * C + b[..., None] * torch.einsum("bnh,bnd->bnhd", k, v)
    n = a * n + b * k
    qf = q.float()
    num = torch.einsum("bnh,bnhd->bnd", qf, C)
    den = torch.maximum((n * qf).sum(dim=-1, keepdim=True).abs(),
                        torch.exp(-m_new)[..., None])
    h = (num / den).reshape(x.shape[0], 1, dm)
    h = L.rmsnorm(h.to(x.dtype), p.head_ln.w)
    h = (h.float() * torch.sigmoid(xg.float())).to(x.dtype)
    return x + h @ p.w_down, (C, n, m_new, window[:, 1:])


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_cell(p: SLSTMLayer, cfg: ModelConfig, zifo_x, state):
    """One timestep. zifo_x: [B, 4d] input contributions; state: (c, n, h
    [B, d], m [B, nh]) f32. m starts at -inf: the first step's forget
    term is exp(-inf) = 0, whose gradient is 0, not NaN."""
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    c, n, h, m = state
    rec = torch.einsum("bnh,gnhd->gbnd", h.reshape(-1, nh, hd).float(),
                       p.r_zifo.float()).reshape(4, -1, d)
    pre = zifo_x.reshape(-1, 4, d).transpose(0, 1).float() + rec + \
        p.b_zifo[:, None, :]
    z_p, i_p, f_p, o_p = pre.unbind(0)
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    log_i = i_p.reshape(-1, nh, hd)
    log_f = F.logsigmoid(f_p).reshape(-1, nh, hd)
    m_new = torch.maximum(log_f + m[..., None], log_i).amax(dim=-1)  # [B,nh]
    a = torch.exp(log_f + m[..., None] - m_new[..., None]).reshape(-1, d)
    b = torch.exp(log_i - m_new[..., None]).reshape(-1, d)
    c = a * c + b * z
    n = a * n + b
    return c, n, o * c / torch.clamp(n, min=1.0), m_new


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM cell over T steps from the zero state (m = -inf), with
    a hand-written backward through time. The loop is host-bound on the
    card (one step is ~20 small kernels), so neither pass builds an
    autograd graph per step: the forward keeps every step's c, n, h and
    m stacked, and the backward recomputes the gates of all steps in a
    few batched ops (to an ulp of the forward's), walks the steps in
    reverse for the carried
    gradients alone, and forms the recurrent weights' gradient in one
    batched matmul. Where ``max`` ties, the gradient is split evenly, as
    ``jax.grad`` splits it.

    forward(x [T,B,nh,4,hd] f32: the input contributions plus biases,
    gates z/i/f/o on axis 3; r2 [nh,hd,4hd] f32: r2[n, j, g*hd + k] =
    r_zifo[g, n, j, k]) -> (h [T,B,nh,hd], and the final c, n [B,nh,hd]
    and m [B,nh], which carry no gradient)."""

    @staticmethod
    def forward(ctx, x, r2):
        _, B_, nh, _, hd = x.shape
        c = torch.zeros((B_, nh, hd), dtype=x.dtype, device=x.device)
        n, h = torch.zeros_like(c), torch.zeros_like(c)
        m = torch.full((B_, nh), float("-inf"), dtype=x.dtype,
                       device=x.device)
        cs, ns, hs, ms = [c], [n], [h], [m]
        for x_t in x.unbind(0):
            rec = torch.bmm(h.transpose(0, 1), r2).view(nh, B_, 4, hd)
            z_p, i_p, f_p, o_p = (x_t + rec.transpose(0, 1)).unbind(2)
            lfm = F.logsigmoid(f_p) + m[..., None]
            m = torch.maximum(lfm, i_p).amax(dim=-1)
            a = torch.exp(lfm - m[..., None])
            b = torch.exp(i_p - m[..., None])
            c = torch.addcmul(a * c, b, torch.tanh(z_p))
            n = torch.addcmul(b, a, n)
            h = torch.sigmoid(o_p) * c / torch.clamp(n, min=1.0)
            cs.append(c)
            ns.append(n)
            hs.append(h)
            ms.append(m)
        c_all, n_all, h_all, m_all = (torch.stack(v) for v in (cs, ns, hs,
                                                               ms))
        ctx.save_for_backward(x, r2, c_all, n_all, h_all, m_all)
        ctx.mark_non_differentiable(c, n, m)
        return h_all[1:], c, n, m

    @staticmethod
    def backward(ctx, dhs, *_):
        x, r2, c_all, n_all, h_all, m_all = ctx.saved_tensors
        T_, B_, nh, _, hd = x.shape
        # every step's gates from the saved states, in batched ops
        hp = h_all[:-1]                                     # h_{t-1}
        rec = torch.bmm(hp.permute(2, 0, 1, 3).reshape(nh, T_ * B_, hd), r2)
        z_p, i_p, f_p, o_p = (x + rec.view(nh, T_, B_, 4, hd).permute(
            1, 2, 0, 3, 4)).unbind(3)
        z, o = torch.tanh(z_p), torch.sigmoid(o_p)
        lfm = F.logsigmoid(f_p) + m_all[:-1, ..., None]
        # the stabilizer anew from these gates (not the saved m): the
        # batched recompute may round an ulp off the forward's, and the
        # argmax test below must find the maximum it compares against
        cand = torch.maximum(lfm, i_p)
        m_new = cand.amax(dim=-1, keepdim=True)
        a = torch.exp(lfm - m_new)
        b = torch.exp(i_p - m_new)
        c, n = c_all[1:], n_all[1:]
        nc = torch.clamp(n, min=1.0)
        half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
        w_n = torch.where(n > 1, 1.0, torch.where(n == 1, half, 0.0))
        q1 = o / nc                                  # dc += dh * q1
        q2 = -o * c / (nc * nc) * w_n                # dn += dh * q2
        q3 = c / nc * o * (1 - o)                    # d pre_o = dh * q3
        qz = b * (1 - z * z)                         # d pre_z = dc * qz
        sf = torch.sigmoid(-f_p)                     # d pre_f = dlf * sf
        # m_new = max over hd of maximum(lfm, i_p): its gradient's share
        # for each element (ties split evenly)
        sel = (cand == m_new).to(x.dtype)
        sel = sel / sel.sum(dim=-1, keepdim=True)
        tie = (lfm == i_p).to(x.dtype) * 0.5
        w_l = sel * ((lfm > i_p).to(x.dtype) + tie)
        w_i = sel * ((i_p > lfm).to(x.dtype) + tie)
        steps = [t.unbind(0) for t in (q1, q2, q3, qz, sf, z, a, b,
                                        c_all[:-1], n_all[:-1], w_l, w_i)]
        r2t = r2.transpose(1, 2)
        dh_rec = torch.zeros((B_, nh, hd), dtype=x.dtype, device=x.device)
        dc, dn = torch.zeros_like(dh_rec), torch.zeros_like(dh_rec)
        dm = torch.zeros((B_, nh), dtype=x.dtype, device=x.device)
        dx = [None] * T_
        for t in reversed(range(T_)):
            (q1t, q2t, q3t, qzt, sft, zt, at, bt, cpt, npt, wlt,
             wit) = (v[t] for v in steps)
            dh = dhs[t] + dh_rec
            dct = torch.addcmul(dc, dh, q1t)
            dnt = torch.addcmul(dn, dh, q2t)
            g_a = (dct * cpt + dnt * npt) * at
            g_b = torch.addcmul(dnt, dct, zt) * bt
            dmn = (dm - (g_a + g_b).sum(dim=-1))[..., None]
            dl = torch.addcmul(g_a, dmn, wlt)
            dm = dl.sum(dim=-1)
            dpre = torch.stack([dct * qzt, torch.addcmul(g_b, dmn, wit),
                                dl * sft, dh * q3t], dim=1)  # [B,4,nh,hd]
            dx[t] = dpre
            dh_rec = torch.bmm(dpre.permute(2, 0, 1, 3).reshape(
                nh, B_, 4 * hd), r2t).transpose(0, 1)
            dc, dn = dct * at, dnt * at
        dx = torch.stack(dx).permute(0, 1, 3, 2, 4)         # [T,B,nh,4,hd]
        dr2 = torch.bmm(hp.permute(2, 3, 0, 1).reshape(nh, hd, T_ * B_),
                        dx.permute(2, 0, 1, 3, 4).reshape(nh, T_ * B_,
                                                          4 * hd))
        return dx, dr2


def _slstm_scan(p: SLSTMLayer, cfg: ModelConfig, zifo):
    """``_slstm_cell`` looped over zifo [B,T,4d] from the zero state
    (``_SLSTMScan``; the bias is added before the recurrent term).
    Returns (h [B,T,d] f32, (c, n, h [B,d], m [B,nh]))."""
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    B_, T_ = zifo.shape[:2]
    x = (zifo.float().reshape(B_, T_, 4, d) + p.b_zifo).reshape(
        B_, T_, 4, nh, hd).permute(1, 0, 3, 2, 4)
    r2 = p.r_zifo.float().permute(1, 2, 0, 3).reshape(nh, hd, 4 * hd)
    hs, c, n, m = _SLSTMScan.apply(x, r2)
    return hs.permute(1, 0, 2, 3).reshape(B_, T_, d), \
        (c.reshape(B_, d), n.reshape(B_, d), hs[-1].reshape(B_, d), m)


def slstm_block(p: SLSTMLayer, cfg: ModelConfig, x, state=None,
                step: bool = False, conv_state=None):
    """The residual sLSTM block and its FFN. Training/prefill (step
    False): the cell looped over T from the zero state (``_slstm_scan``).
    Decode (step True): one token from ``state`` and ``conv_state``
    [B, k-1, d]. Returns (x, cell state, new conv state or None)."""
    xn = L.apply_norm(cfg, p.ln, x)
    if step:
        window = torch.cat([conv_state, xn], dim=1)
        new_conv = window[:, 1:]
        xc = _conv_step(window, p.conv_w, p.conv_b, x.dtype)
    else:
        xc = _causal_depthwise_conv(xn, p.conv_w, p.conv_b)
        new_conv = None
    zifo = xc @ p.w_zifo                                      # [B,T,4d]
    if step:
        if state is None:
            raise ValueError("slstm_block(step=True) needs the cell state")
        state = _slstm_cell(p, cfg, zifo[:, 0], state)
        h = state[2][:, None]
    else:
        h, state = _slstm_scan(p, cfg, zifo)                  # [B,T,d]
    h = L.apply_norm(cfg, p.group_ln, h.to(x.dtype))
    x = x + h
    hn = L.apply_norm(cfg, p.ffn_ln, x)
    return x + L.run_mlp(p.ffn, hn, "gelu"), state, new_conv


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def _layer_plan(cfg: ModelConfig):
    """[("m" | "s", index within its kind)] per layer."""
    s_at = set(cfg.xlstm.slstm_at)
    plan, mi, si = [], 0, 0
    for i in range(cfg.num_layers):
        if i in s_at:
            plan.append(("s", si))
            si += 1
        else:
            plan.append(("m", mi))
            mi += 1
    return plan


def _slstm_out(cfg: ModelConfig, p: SLSTMLayer, x):
    return slstm_block(p, cfg, x)[0]


def hidden(model: XLSTMLM, cfg: ModelConfig, batch):
    """(final hidden [B,T,d], {"aux_loss": 0.0}); every block under
    ``T.remat``."""
    x = T.embed_tokens(model, cfg, batch)
    for kind, j in _layer_plan(cfg):
        if kind == "m":
            fn = functools.partial(mlstm_block, model.mlstm_layers[j], cfg)
        else:
            fn = functools.partial(_slstm_out, cfg, model.slstm_layers[j])
        x = T.remat(cfg, fn, x)
    return L.apply_norm(cfg, model.final_ln, x), T.aux_dict(0.0, x)


def forward(model: XLSTMLM, cfg: ModelConfig, batch):
    h, aux = hidden(model, cfg, batch)
    return T.unembed(model, cfg, h), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device="cuda"):
    """Per-layer recurrent state (``max_len`` is not used: the state does
    not grow): m_C [n_m,B,nh,hd,hd], m_n, m_m (0) f32, m_conv
    [n_m,B,k-1,dm]; with sLSTM layers s_c, s_n, s_h [n_s,B,d] f32, s_m
    [n_s,B,nh] = -inf, s_conv [n_s,B,k-1,d]."""
    dev = resolve_device(device)
    dtype = T.torch_dtype(cfg) if dtype is None else dtype
    d, dm, nh, hd = _dims(cfg)
    n_m, n_s = _counts(cfg)
    k = cfg.xlstm.conv_kernel
    f32 = torch.float32

    def z(*shape, dt=f32):
        return torch.zeros(shape, dtype=dt, device=dev)
    c = {"m_C": z(n_m, batch, nh, hd, hd), "m_n": z(n_m, batch, nh, hd),
         "m_m": z(n_m, batch, nh), "m_conv": z(n_m, batch, k - 1, dm,
                                               dt=dtype)}
    if n_s:
        c.update({"s_c": z(n_s, batch, d), "s_n": z(n_s, batch, d),
                  "s_h": z(n_s, batch, d),
                  "s_m": torch.full((n_s, batch, cfg.num_heads),
                                    float("-inf"), dtype=f32, device=dev),
                  "s_conv": z(n_s, batch, k - 1, d, dt=dtype)})
    return c


def decode_step(model: XLSTMLM, cfg: ModelConfig, cache, batch):
    """One token a row (tokens [B,1]). Updates the cache's tensors in
    place (the JAX function returns a new cache) and returns (logits
    [B,1,V], cache)."""
    x = T.embed_tokens(model, cfg, batch)
    for kind, j in _layer_plan(cfg):
        if kind == "m":
            state = tuple(cache[key][j]
                          for key in ("m_C", "m_n", "m_m", "m_conv"))
            x, new = mlstm_step(model.mlstm_layers[j], cfg, x, state)
            keys = ("m_C", "m_n", "m_m", "m_conv")
        else:
            state = tuple(cache[key][j] for key in ("s_c", "s_n", "s_h",
                                                    "s_m"))
            x, cell, conv = slstm_block(model.slstm_layers[j], cfg, x,
                                        state=state, step=True,
                                        conv_state=cache["s_conv"][j])
            new, keys = (*cell, conv), ("s_c", "s_n", "s_h", "s_m", "s_conv")
        for key, val in zip(keys, new):
            cache[key][j] = val
    h = L.apply_norm(cfg, model.final_ln, x)
    return T.unembed(model, cfg, h), cache
