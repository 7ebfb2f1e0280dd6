"""Train-step builders (the counterpart of ``repro.training.steps``).

``make_train_step(cfg)`` -> ``step(model, opt_state, batch)`` for the
port's dense LM; cross-entropy is chunked over the sequence
(``cfg.loss_chunk``), each chunk's logits recomputed in the backward, so
the full [B,T,V] logits never exist at once.

``make_mllm_train_step(mllm)`` -> the Cornstarch path: frozen-aware
MLLM training (encoders + projectors + LLM). The loss counts text slots
only. Gradients are taken for trainable parameters alone, so the
backward never computes a frozen weight's gradient; through the frozen
LLM it computes input gradients only (with ``attn_impl="bam_kernel"``,
K2 and K3 on every layer), down to the projector.

A step updates the parameters in place and returns
``(params, opt_state, metrics)`` like the JAX step; metrics hold 0-dim
tensors (read them with ``float``, which waits for the device).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, valid=None):
    """Mean next-token NLL in f32, over ``valid`` positions if given."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if valid is None:
        return nll.mean()
    w = valid.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def chunked_cross_entropy(h, model, cfg: ModelConfig, labels, valid=None,
                          chunk: Optional[int] = None):
    """h: [B,T,d] final hidden. Sums the NLL over sequence chunks so
    only [B,chunk,V] logits exist at a time (recomputed in backward)."""
    B, T_, _ = h.shape
    c = chunk or cfg.loss_chunk
    if not c or T_ % c != 0:
        return cross_entropy(T.unembed(model, cfg, h), labels, valid)
    w_all = torch.ones(labels.shape, device=h.device) if valid is None \
        else valid.float()

    def f(hc, lc, wc):
        logits = T.unembed(model, cfg, hc).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        return ((lse - ll) * wc).sum()

    tot = torch.zeros((), device=h.device)
    for s in range(0, T_, c):
        tot = tot + checkpoint(f, h[:, s:s + c], labels[:, s:s + c],
                               w_all[:, s:s + c], use_reentrant=False)
    return tot / torch.clamp(w_all.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Gradients and the optimizer step
# ---------------------------------------------------------------------------

def _grads(loss, params: Dict[str, torch.Tensor]):
    """{name: grad or None}; only parameters that require grad are
    differentiated."""
    names = [n for n, p in params.items() if p.requires_grad]
    gs = torch.autograd.grad(loss, [params[n] for n in names],
                             allow_unused=True) if names else ()
    grads = dict.fromkeys(params)
    grads.update(zip(names, gs))
    return grads


# ---------------------------------------------------------------------------
# LM train step
# ---------------------------------------------------------------------------

def make_loss_fn(cfg: ModelConfig):
    mod = api.module_for(cfg)

    def loss_fn(model, batch):
        valid = batch.get("valid")
        if cfg.loss_chunk and hasattr(mod, "hidden"):
            h = mod.hidden(model, cfg, batch)
            loss = chunked_cross_entropy(h, model, cfg, batch["labels"],
                                         valid)
            aux = {}
        else:
            logits, aux = mod.forward(model, cfg, batch)
            loss = cross_entropy(logits, batch["labels"], valid)
        return loss + aux.get("aux_loss", 0.0), {"ce": loss, **aux}

    return loss_fn


def make_train_step(cfg: ModelConfig, ocfg: Optional[opt.AdamWConfig] = None,
                    frozen_mask: Optional[Dict[str, bool]] = None):
    """``step(model, opt_state, batch)``; ``model``'s parameters that
    are not frozen must require grad."""
    ocfg = ocfg or opt.AdamWConfig()
    loss_fn = make_loss_fn(cfg)

    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss, metrics = loss_fn(model, batch)
        grads = _grads(loss, params)
        _, opt_state, om = opt.update(ocfg, grads, opt_state, params,
                                      frozen_mask)
        return model, opt_state, {"loss": loss.detach(), **metrics, **om}

    return step


# ---------------------------------------------------------------------------
# Cornstarch MLLM train step (frozen-aware)
# ---------------------------------------------------------------------------

def make_mllm_train_step(mllm, ocfg: Optional[opt.AdamWConfig] = None):
    """Returns (step, loss_fn). ``step(params, opt_state, batch)`` with
    ``params`` from ``mllm.init`` (or the bridge) and ``opt_state`` from
    ``optimizer.init(ocfg, dict(params.named_parameters()),
    mllm.frozen_mask(params))``."""
    ocfg = ocfg or opt.AdamWConfig()

    def loss_fn(params, batch):
        (logits, aux), merged = mllm.forward(params, batch)
        # loss over text positions only (modality tokens carry no
        # labels); the text stream's labels are scattered to text slots
        is_text = (merged["bits"] != 0) & ~merged["embed_mask"]
        txt_idx = torch.cumsum(is_text.to(torch.int32), dim=1) - 1
        lab_src = batch["labels"]
        gathered = torch.gather(
            lab_src, 1,
            torch.clamp(txt_idx, 0, lab_src.shape[1] - 1).long())
        labels = torch.where(is_text, gathered, torch.zeros_like(gathered))
        loss = cross_entropy(logits, labels, valid=is_text)
        return loss + aux.get("aux_loss", 0.0), {"ce": loss.detach()}

    def step(params, opt_state, batch):
        # the frozen flags are plain python bools on the module, read
        # anew each step as the JAX step does
        frozen_mask = mllm.frozen_mask(params)
        mllm.apply_freeze(params)
        named = dict(params.named_parameters())
        loss, metrics = loss_fn(params, batch)
        grads = _grads(loss, named)
        _, opt_state, om = opt.update(ocfg, grads, opt_state, named,
                                      frozen_mask)
        return params, opt_state, {"loss": loss.detach(), **metrics, **om}

    return step, loss_fn
