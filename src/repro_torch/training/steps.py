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

``make_cp_train_step(cfg, layout, group)`` -> context-parallel training
(Cornstarch §4.3) on the ranks of a ``torch.distributed`` process group:
each rank permutes the batch to the ``ContextPlan`` layout, keeps its
own run of tokens, and attention crosses ranks through
``core.context_parallel``; loss and gradients equal the unpermuted
``make_train_step``'s.

``make_spmd_train_step(stage_fn, graph, sim)`` -> pipeline-parallel
training with one process per pipeline rank: each step runs the plan's
compiled wave program through ``parallel.spmd``'s runner and applies
AdamW to this rank's stages; its gradient pass, norm and parameters are
also exposed on their own, for the guarded step.

``make_prefill(cfg)`` -> ``prefill(model, batch)``, the last position's
logits, and ``make_serve_step(cfg)`` -> ``serve_step(model, cache,
batch)``, one greedy token a row on the strip cache
(``models.api.decode_step``); both run without autograd.

A step updates the parameters in place and returns
``(params, opt_state, metrics)`` like the JAX step; metrics hold 0-dim
tensors (read them with ``float``, which waits for the device).
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch
import torch.distributed as dist
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


def _nll_sum(h, model, cfg: ModelConfig, labels, valid=None,
             chunk: Optional[int] = None):
    """(Σ w·NLL, Σ w) over [B,T] from the final hidden h [B,T,d], w the
    ``valid`` weights (1 if None). The sum runs over sequence chunks of
    ``cfg.loss_chunk`` when T divides by it, so only [B,chunk,V] logits
    exist at a time (recomputed in backward)."""
    B, T_, _ = h.shape
    w_all = torch.ones(labels.shape, device=h.device) if valid is None \
        else valid.float()

    def f(hc, lc, wc):
        logits = T.unembed(model, cfg, hc).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        return ((lse - ll) * wc).sum()

    c = chunk or cfg.loss_chunk
    if not c or T_ % c != 0:
        return f(h, labels, w_all), w_all.sum()
    tot = torch.zeros((), device=h.device)
    for s in range(0, T_, c):
        tot = tot + checkpoint(f, h[:, s:s + c], labels[:, s:s + c],
                               w_all[:, s:s + c], use_reentrant=False)
    return tot, w_all.sum()


def _logits_nll_sum(logits, labels, valid=None):
    """(Σ w·NLL, Σ w) over [B,T] from whole logits [B,T,V] (the families
    without ``hidden``)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels.long()[..., None])[..., 0]
    w = torch.ones_like(nll) if valid is None else valid.float()
    return (nll * w).sum(), w.sum()


def chunked_cross_entropy(h, model, cfg: ModelConfig, labels, valid=None,
                          chunk: Optional[int] = None):
    """h: [B,T,d] final hidden. Mean NLL over ``valid`` positions, summed
    over sequence chunks (``_nll_sum``)."""
    B, T_, _ = h.shape
    c = chunk or cfg.loss_chunk
    if not c or T_ % c != 0:
        return cross_entropy(T.unembed(model, cfg, h), labels, valid)
    tot, cnt = _nll_sum(h, model, cfg, labels, valid, c)
    return tot / torch.clamp(cnt, min=1.0)


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
            h, aux = mod.hidden(model, cfg, batch)
            loss = chunked_cross_entropy(h, model, cfg, batch["labels"],
                                         valid)
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
# Serve step (decode shapes) and prefill
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(model, cache, batch):
        """(next token [B] int32, cache) after one ``decode_step``."""
        logits, cache = api.decode_step(model, cfg, cache, batch)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache
    return serve_step


def make_prefill(cfg: ModelConfig):
    """prefill = the forward returning the last position's logits [B,1,V]:
    with ``cfg.loss_chunk`` and a module that has ``hidden``, the final
    hidden states and a one-position unembed; else the full forward,
    whose last position is copied out so that the [B,T,V] logits are
    freed on return (a view would keep them alive)."""
    mod = api.module_for(cfg)

    @torch.no_grad()
    def prefill(model, batch):
        if cfg.loss_chunk and hasattr(mod, "hidden"):
            h, _ = mod.hidden(model, cfg, batch)
            return T.unembed(model, cfg, h[:, -1:, :])
        logits, _ = mod.forward(model, cfg, batch)
        return logits[:, -1:, :].clone()
    return prefill


# ---------------------------------------------------------------------------
# Context-parallel train step (Cornstarch §4.3)
# ---------------------------------------------------------------------------

#: batch keys whose token axis follows the CP permutation -> token axis
#: (pos3 is [3, B, T]: M-RoPE position ids travel with their tokens)
_CP_TOKEN_KEYS = {"tokens": 1, "labels": 1, "positions": 1, "bits": 1,
                  "valid": 1, "inputs_embeds": 1, "embed_mask": 1,
                  "pos3": 2}

#: families whose recurrence runs along the token axis -> what it is
_CP_RECURRENCE = {"hybrid": "the hybrid's SSM recurrence",
                  "ssm": "xLSTM's mLSTM/sLSTM recurrence"}


def make_cp_train_step(cfg: ModelConfig, layout, group,
                       ocfg: Optional[opt.AdamWConfig] = None, *,
                       method: str = "allgather",
                       frozen_mask: Optional[Dict[str, bool]] = None):
    """Context-parallel LM train step, ``step(model, opt_state, batch)``,
    to be called on every rank of ``group`` (a ``torch.distributed``
    ProcessGroup) with the same whole batch and the same weights.

    ``layout`` is ``ContextPlan.apply(seq_len)``'s dict. Each step
    permutes every token-axis batch tensor to plan layout by
    ``layout["perm"]``, keeps this rank's contiguous run of seq_len/G
    tokens (positions and bits travel with them) and runs the ordinary
    loss there, attention going through
    ``core.context_parallel.cp_attention`` (``method``: allgather or
    ring; per-chunk math ``cfg.attn_impl``; each layer's own window, so
    gemma2's local/global alternation is context parallel too). The
    cross-entropy's sum and count come from ``hidden`` and the chunked
    unembed, or from the forward's logits for a family without
    ``hidden`` (vlm), as the JAX loss does. They are all-reduced over the
    group, and so is the router's aux loss (each rank's share: the MoE
    layers all-reduce their expert statistics, ``models.moe``) and every
    trainable gradient before AdamW, so every rank takes the same update
    and the loss and gradients equal the JAX CP step's: for the dense
    and vlm families also ``make_train_step``'s on the unpermuted batch;
    for MoE the capacity drops and the aux loss are the permuted row's,
    as in JAX. Whisper's ``encoder_embeds`` is not on the token axis:
    every rank keeps it whole and runs the encoder over all frames, and
    the decoder's self-attention goes through ``cp_attention``, so its
    loss and gradients equal the plain step's too. The hybrid and xLSTM
    families are refused (``_CP_RECURRENCE``): a recurrence runs along
    the token axis, and a rank's run of a permuted sequence is not a
    sequence."""
    ocfg = ocfg or opt.AdamWConfig()
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"make_cp_train_step needs a torch.distributed "
                        f"ProcessGroup, got {type(group).__name__}")
    if cfg.family in _CP_RECURRENCE:
        raise ValueError(
            f"{cfg.name}: context parallelism splits the token axis, and "
            f"{_CP_RECURRENCE[cfg.family]} runs along it, so a rank's run "
            f"of the permuted sequence is not a sequence; the JAX CP step "
            f"runs it over the permuted order and differs from the plain "
            f"step (ROADMAP.md queue 3)")
    G = dist.get_world_size(group)
    rank = dist.get_rank(group)
    perm_np = layout["perm"]
    seq_len = len(perm_np)
    if seq_len % G:
        raise ValueError(
            f"seq_len {seq_len} is not divisible by the {G} ranks of the "
            f"CP group; pad the sequence to a rank multiple before "
            f"planning")
    if layout["num_ranks"] != G:
        # exact on any group size, but the plan's balance holds only
        # when its rank slices are the group's
        warnings.warn(
            f"ContextPlan was balanced for {layout['num_ranks']} ranks "
            f"but the CP group has {G}; results are exact but the planned "
            f"load balance is lost", stacklevel=2)
    cp_cfg = cfg.replace(cp_mesh=group, cp_method=method, attn_q_chunk=0)
    mod = api.module_for(cp_cfg)
    local = slice(rank * (seq_len // G), (rank + 1) * (seq_len // G))

    def shard(batch):
        """This rank's run of the batch in plan layout."""
        out = dict(batch)
        for key, axis in _CP_TOKEN_KEYS.items():
            x = batch.get(key)
            if x is not None:
                perm = torch.as_tensor(perm_np[local], device=x.device)
                out[key] = torch.index_select(x, axis, perm)
        return out

    def step(model, opt_state, batch):
        if batch.get("bits") is None:
            # without bits run_attention cannot dispatch to cp_attention,
            # and each rank would attend over its own run alone
            raise ValueError(
                "make_cp_train_step needs batch['bits'] (BAM bitfields); "
                "use bam.causal_bits for pure-text batches")
        params = dict(model.named_parameters())
        pb = shard(batch)
        if hasattr(mod, "hidden"):
            h, aux = mod.hidden(model, cp_cfg, pb)
            tot, cnt = _nll_sum(h, model, cp_cfg, pb["labels"],
                                pb.get("valid"))
        else:
            logits, aux = mod.forward(model, cp_cfg, pb)
            tot, cnt = _logits_nll_sum(logits, pb["labels"], pb.get("valid"))
        aux = torch.as_tensor(aux.get("aux_loss", 0.0), dtype=torch.float32,
                              device=tot.device)
        sums = torch.stack([tot.detach(), cnt.detach(), aux.detach()])
        dist.all_reduce(sums, group=group)
        denom = torch.clamp(sums[1], min=1.0)
        grads = _grads(tot / denom + aux, params)
        for name, p in params.items():
            if p.requires_grad:
                # every rank must join every all-reduce: an unused
                # trainable leaf contributes zeros
                if grads[name] is None:
                    grads[name] = torch.zeros_like(p)
                dist.all_reduce(grads[name], group=group)
        ce = sums[0] / denom
        _, opt_state, om = opt.update(ocfg, grads, opt_state, params,
                                      frozen_mask)
        return model, opt_state, {"loss": ce + sums[2], "ce": ce,
                                  "aux_loss": sums[2], **om}

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


# ---------------------------------------------------------------------------
# SPMD pipeline train step (one process per pipeline rank)
# ---------------------------------------------------------------------------

def make_spmd_train_step(stage_fn, graph, sim,
                         ocfg: Optional[opt.AdamWConfig] = None, *,
                         group=None, microbatch_loss=None, frozen_mask=None,
                         trainable=None, grad_scale: float = 1.0,
                         dispatch: str = "rolled", program=None):
    """Pipeline-parallel train step driven by a simulated schedule and
    run by ``parallel.spmd.build_spmd_runner`` on this rank of ``group``
    (call it on every rank).

    ``stage_fn``, ``microbatch_loss`` and ``trainable`` follow
    ``execute_schedule``'s contract (a ``models.stages.StageBundle``
    gives all three); ``graph`` and ``sim`` are ``executor["sim_graph"]``
    and ``executor["schedule"]`` of ``plan.apply(mllm, mode="spmd")``,
    whose ``"spmd_program"`` may be passed as ``program``. ``step(
    stage_params, opt_state, microbatches)`` runs the schedule once,
    scales the summed per-microbatch loss and gradients by
    ``grad_scale`` (1/M for ``StageBundle.microbatch_loss``) and applies
    AdamW to the parameters of the stages this rank hosts, in place,
    clipped by the global gradient norm over every rank. ``stage_params``
    is a stage list (None for the stages other ranks host) or a
    stage-stacked dict; ``frozen_mask`` is a per-stage list of {name:
    frozen} (``StageBundle.frozen_masks``), and frozen slots get no
    optimizer state. Pass ``opt_state=None`` on the first call: the step
    creates the state over this rank's parameters, keyed
    ``"<stage>:<name>"``. Returns ``(stage_params, opt_state, {"loss",
    "grad_norm", "lr"})``, the loss summed over ranks.

    Its parts, for the guarded step (``resilience.monitor``), are
    attributes: ``value_and_grad(stage_params, microbatches) -> (loss,
    grads)`` runs the schedule and scales both, ``global_norm(grads)``
    all-reduces the norm, ``named_parameters(stage_params)`` and
    ``frozen_mask`` key AdamW's state."""
    from repro_torch.parallel import spmd
    ocfg = ocfg or opt.AdamWConfig()
    runner = spmd.build_spmd_runner(
        stage_fn, graph, sim, group=group, microbatch_loss=microbatch_loss,
        trainable=trainable, dispatch=dispatch, program=program)
    hosted = runner.program.hosted[runner.rank]
    mask = {f"{s}:{name}": frozen
            for s in hosted for name, frozen in
            (frozen_mask[s].items() if frozen_mask is not None else ())}
    where = {}

    def named_parameters(stage_params):
        return spmd.local_named_parameters(stage_params, hosted)

    def value_and_grad(stage_params, microbatches):
        """(loss, {"<stage>:<name>": gradient}), both scaled."""
        where["device"] = microbatches.device
        res = runner(stage_params, microbatches)
        pg = res["param_grads"]
        grads = {}
        for s in hosted:
            per = pg[s] if isinstance(pg, list) else \
                {k: v[s] for k, v in pg.items()}
            for name, g in per.items():
                grads[f"{s}:{name}"] = g * grad_scale
        return res["loss"] * grad_scale, grads

    def global_norm(grads):
        """The norm over every rank's gradients (all ranks call it; gloo
        reduces CPU tensors)."""
        device = where["device"]
        dev = device if dist.get_backend(runner.group) == "nccl" else "cpu"
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for g in grads.values():
            if g is not None:
                sq = sq + torch.sum(torch.square(g.float())).to(dev)
        dist.all_reduce(sq, group=runner.group)
        return torch.sqrt(sq).to(device)

    def step(stage_params, opt_state, microbatches):
        named = named_parameters(stage_params)
        if opt_state is None:
            opt_state = opt.init(ocfg, named, mask)
        loss, grads = value_and_grad(stage_params, microbatches)
        _, opt_state, om = opt.update(ocfg, grads, opt_state, named, mask,
                                      grad_norm=global_norm(grads))
        return stage_params, opt_state, {"loss": loss, **om}

    step.runner = runner
    step.value_and_grad = value_and_grad
    step.global_norm = global_norm
    step.named_parameters = named_parameters
    step.frozen_mask = mask
    return step

