"""Per-stage callables of a real MLLM (the counterpart of
``repro.models.stages``).

``core.modality_parallel.execute_schedule`` moves one activation tensor
per stage handoff, but an MLLM's stage boundaries differ: an encoder's
hidden state is [B, T_m, d_m], the LLM's [B, T_c, d_llm], and the LLM
also needs the text tokens and labels no upstream activation carries.
``build_mllm_stages`` closes that gap with a carrier encoding and a
three-argument stage function

    stage_fn(stage_params, x, microbatch) -> y

* The carrier is one f32 tensor [B, T_c, d_c] over the merged sequence
  (T_c = ``mllm.merged_length(text_len)``, d_c the widest of the LLM and
  the encoders). Encoder stages read and write their modality's rows in
  channels [:d_m]; the last encoder stage writes the projected output in
  channels [:d_llm]. Text rows of the microbatch carrier hold the token
  id in channel 0 and the label in channel 1 (exact in f32 below 2^24);
  modality rows hold raw embeddings there, so token and label reads are
  masked by the static text mask.
* Stages follow the executor contract's simulated graph
  (``executor["sim_graph"]``), grouped by ``Stage.module`` and checked
  to tile each module's layers. Boundary stages own the boundary
  parameters: final_ln and projector on the last encoder stage, the
  embedding on the first LLM stage, final_ln and unembed on the last.
* A stage's parameters are a :class:`StageParams` module that holds the
  ``MLLMParams``' own ``nn.Parameter``s, shared and not copied, under
  their full names (``llm.layers.3.attn.wq``), so ``partition`` and
  ``unpartition`` are an exact bijection and a stage's gradients are
  keyed as the whole model's. Frozen parameters keep
  ``requires_grad=False``, so autograd never computes their gradient;
  a frozen encoder stage with no input gradient to give runs without
  autograd. ``frozen_masks`` mirrors the frozen flags for AdamW, and
  ``trainable`` tells the executor which stages produce weight
  gradients even when the cost model gave them no W work (a frozen
  encoder's last stage with its trainable projector).

The sink stage emits per-token NLL in carrier channel 0;
``microbatch_loss`` reduces it so that the sum over microbatches divided
by their count is ``make_mllm_train_step``'s cross-entropy.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import bam
from repro_torch.models import layers as L
from repro_torch.models import mllm as Mm
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage of the partitioned MLLM (host-side, static)."""
    kind: str            # "encoder" | "llm"
    module: str          # encoder name, or "llm"
    lo: int              # module-local first layer (inclusive)
    hi: int              # module-local last layer (exclusive)
    first: bool          # first stage of its module chain
    last: bool           # last stage of its module chain
    trainable: bool      # does this stage hold any trainable params?


class StageParams(nn.Module):
    """One stage's parameters: the whole model's ``nn.Parameter``s (and
    the submodules holding them), registered under their full names.
    ``llm.layers`` and ``encoders.<name>.module.layers`` are
    ``ModuleDict``s keyed by the model's layer index."""


def _container(**children) -> nn.Module:
    mod = nn.Module()
    for key, val in children.items():
        setattr(mod, key, val)
    return mod


@dataclasses.dataclass
class StageBundle:
    """Everything the executor needs to run a real MLLM: per-stage
    callables, the partition of its parameters, and the carrier codec."""
    mllm: Any
    specs: List[StageSpec]
    stage_fns: List[Callable]
    text_len: int
    merged_len: int
    d_carrier: int
    # static merge geometry (host numpy)
    bits_np: Any
    pos_np: Any
    emask_np: Any
    is_text_np: Any
    text_pos_np: Any
    slots: Dict[str, Tuple[int, int, int]]   # name -> (offset, n, d_m)

    # -- carrier codec ------------------------------------------------------
    @property
    def n_text(self) -> int:
        return int(self.is_text_np.sum())

    @property
    def trainable(self) -> Tuple[bool, ...]:
        return tuple(s.trainable for s in self.specs)

    def encode_microbatches(self, batch, num_microbatches: int):
        """batch: {"text_tokens" [B,T], "labels" [B,T],
        f"{name}_embeds" [B,n,d_m]} -> f32 carrier [M, B/M, T_c, d_c] on
        the batch's device."""
        toks = batch["text_tokens"]
        B = toks.shape[0]
        M = int(num_microbatches)
        if B % M != 0:
            raise ValueError(
                f"batch size {B} not divisible by {M} microbatches")
        dev = toks.device
        car = torch.zeros((B, self.merged_len, self.d_carrier),
                          dtype=torch.float32, device=dev)
        tpos = torch.as_tensor(self.text_pos_np, device=dev)
        car[:, tpos, 0] = toks.float()
        car[:, tpos, 1] = batch["labels"].float()
        for name, (off, n, dm) in sorted(self.slots.items()):
            car[:, off:off + n, :dm] = batch[f"{name}_embeds"].float()
        return car.reshape(M, B // M, self.merged_len, self.d_carrier)

    def microbatch_loss(self, y):
        """Sink-stage output -> scalar. Summed over the M microbatches
        this is M x the full-batch cross-entropy (the text count per
        sample is static), so callers scale by 1/M."""
        n = max(self.n_text, 1)
        return torch.sum(y[..., 0].float()) / (y.shape[0] * n)

    # -- params -------------------------------------------------------------
    def partition(self, params) -> List[StageParams]:
        """``MLLMParams`` -> per-stage ``StageParams`` (plan order),
        sharing the parameters."""
        out = []
        for sp in self.specs:
            st = StageParams()
            layers_of = range(sp.lo, sp.hi)
            if sp.kind == "encoder":
                src = params.encoders[sp.module]
                enc = _container(layers=nn.ModuleDict(
                    {str(i): src.module.layers[i] for i in layers_of}))
                mod = _container(module=enc)
                if sp.last:
                    enc.final_ln = src.module.final_ln
                    mod.projector = src.projector
                st.encoders = nn.ModuleDict({sp.module: mod})
            else:
                src = params.llm
                llm = _container(layers=nn.ModuleDict(
                    {str(i): src.layers[i] for i in layers_of}))
                if sp.first:
                    llm.embed = src.embed
                if sp.last:
                    llm.final_ln = src.final_ln
                    if not self.mllm.llm_cfg.tie_embeddings:
                        llm.unembed = src.unembed
                st.llm = llm
            out.append(st)
        return out

    def unpartition(self, stage_params: Sequence[nn.Module]):
        """Exact inverse of ``partition``: an ``MLLMParams`` whose every
        parameter is the stages' own, under the same name. Raises
        ``ValueError`` unless the stages hold each parameter once."""
        whole = self.mllm.init(device="meta")
        want = dict(whole.named_parameters())
        seen = set()
        for st in stage_params:
            for name, p in st.named_parameters():
                if name not in want or name in seen:
                    raise ValueError(f"stage parameter {name!r} is not a "
                                     f"parameter of the model, or held "
                                     f"twice")
                seen.add(name)
                owner, _, leaf = name.rpartition(".")
                setattr(whole.get_submodule(owner), leaf, p)
        if seen != set(want):
            raise ValueError(f"stages miss {sorted(set(want) - seen)}")
        return whole

    def frozen_masks(self, stage_params: Sequence[nn.Module]
                     ) -> List[Dict[str, bool]]:
        """Per-stage {parameter name: True if frozen}, for AdamW."""
        out = []
        for st in stage_params:
            mask = {}
            for name, _ in st.named_parameters():
                parts = name.split(".")
                if parts[0] == "llm":
                    mask[name] = self.mllm.frozen_llm
                else:
                    enc = self.mllm.encoders[parts[1]]
                    mask[name] = (enc.frozen_module if parts[2] == "module"
                                  else enc.frozen_projector)
            out.append(mask)
        return out

    def hosted_share(self, params, hosted
                     ) -> Tuple[List[Optional[StageParams]],
                                List[Dict[str, bool]]]:
        """One pipeline rank's share of ``params``: the ``StageParams``
        of the stages in ``hosted`` (None for the others, so that nothing
        here keeps another rank's parameters once the caller drops
        ``params``) and every stage's frozen mask."""
        stages = self.partition(params)
        masks = self.frozen_masks(stages)
        hosted = set(hosted)
        return [sp if s in hosted else None
                for s, sp in enumerate(stages)], masks

    @property
    def layout_meta(self) -> Dict[str, Any]:
        """JSON-able stage layout (for a checkpoint's manifest)."""
        return {
            "text_len": self.text_len,
            "merged_len": self.merged_len,
            "d_carrier": self.d_carrier,
            "stages": [dataclasses.asdict(s) for s in self.specs],
        }


# ---------------------------------------------------------------------------
# Stage grouping from the simulated graph
# ---------------------------------------------------------------------------

def _group_stages(mllm, graph) -> List[StageSpec]:
    per_module: Dict[str, List[int]] = {}
    for i, st in enumerate(graph.stages):
        per_module.setdefault(st.module, []).append(i)
    specs: List[StageSpec] = [None] * len(graph.stages)   # type: ignore
    for module, idxs in per_module.items():
        if module == "llm":
            n_layers = mllm.llm_cfg.num_layers
        elif module in mllm.encoders:
            n_layers = mllm.encoders[module].cfg.num_layers
        else:
            raise ValueError(
                f"graph stage module {module!r} is not an encoder of this "
                f"MLLM (encoders: {sorted(mllm.encoders)}) nor 'llm'")
        idxs = sorted(idxs, key=lambda i: graph.stages[i].layer_range[0])
        want = 0
        for k, i in enumerate(idxs):
            lo, hi = graph.stages[i].layer_range
            if lo != want or hi < lo:
                raise ValueError(
                    f"stages of module {module!r} do not tile its layers "
                    f"contiguously: got range ({lo}, {hi}) expecting "
                    f"lo={want}")
            want = hi
            first, last = (k == 0), (k == len(idxs) - 1)
            if module == "llm":
                trainable = not mllm.frozen_llm
            else:
                enc = mllm.encoders[module]
                trainable = (not enc.frozen_module) or \
                    (last and not enc.frozen_projector)
            specs[i] = StageSpec(
                kind="llm" if module == "llm" else "encoder",
                module=module, lo=lo, hi=hi, first=first, last=last,
                trainable=trainable)
        if want != n_layers:
            raise ValueError(
                f"stages of module {module!r} cover layers [0, {want}) "
                f"but the module has {n_layers}")
    return specs


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def build_mllm_stages(mllm, executor: Mapping[str, Any], *,
                      text_len: int) -> StageBundle:
    """Partition ``mllm`` per the executor contract's simulated graph
    into a :class:`StageBundle` whose ``stage_fns`` and ``partition``
    feed ``execute_schedule``. The stage fns read ``mllm``'s configs as
    they are now (``attn_impl``, ``remat``, dtypes)."""
    graph = executor["sim_graph"]
    specs = _group_stages(mllm, graph)
    llm_cfg = mllm.llm_cfg
    if llm_cfg.tie_embeddings and \
            sum(1 for s in specs if s.kind == "llm") > 1:
        raise ValueError(
            "tie_embeddings requires the LLM to be a single pipeline "
            "stage (embedding and head live on different stages)")

    # static merge geometry, constructed as build_merge does
    layout = mllm.layout or mllm.default_layout(text_len)
    total = mllm.merged_length(text_len)
    segs, t_used = [], 0
    for seg in layout:
        if seg[0] == "text":
            segs.append(("text", 0, seg[1]))
            t_used += seg[1]
        else:
            enc = mllm.encoders[seg[0]]
            segs.append(("mod", enc.modality_id, enc.num_tokens))
    if t_used != text_len:
        raise ValueError(f"layout text length {t_used} != {text_len}")
    bits_np, pos_np = bam.build_sample_bits(segs, total)
    emask_np = np.zeros((total,), bool)
    slots: Dict[str, Tuple[int, int, int]] = {}
    off = 0
    for seg in layout:
        if seg[0] == "text":
            off += seg[1]
        else:
            enc = mllm.encoders[seg[0]]
            slots[seg[0]] = (off, enc.num_tokens, enc.cfg.d_model)
            emask_np[off:off + enc.num_tokens] = True
            off += enc.num_tokens
    is_text_np = (np.asarray(bits_np) != 0) & (~emask_np)
    text_pos_np = np.where(is_text_np)[0]
    d_llm = llm_cfg.d_model
    d_carrier = max([d_llm] + [e.cfg.d_model
                               for e in mllm.encoders.values()])

    @functools.lru_cache(maxsize=None)
    def geometry(device: torch.device):
        """(bits, positions [T_c] int32, embed mask, text mask [T_c]
        bool) on ``device``, uploaded once."""
        return (torch.from_numpy(np.asarray(bits_np, np.int32)).to(device),
                torch.from_numpy(np.asarray(pos_np, np.int32)).to(device),
                torch.from_numpy(emask_np).to(device),
                torch.from_numpy(is_text_np).to(device))

    def make_encoder_fn(sp: StageSpec):
        enc = mllm.encoders[sp.module]
        off, n, dm = slots[sp.module]

        def fn(lp, x, mb):
            cfg = enc.cfg
            Tc, dc = x.shape[1], x.shape[2]
            rows = (off, Tc - off - n)
            h = x[:, off:off + n, :dm].to(T.torch_dtype(cfg))
            B = h.shape[0]
            pos = torch.arange(n, dtype=torch.int32,
                               device=x.device)[None].expand(B, n)
            src = lp.encoders[sp.module]
            # a frozen module with no input gradient to give records
            # nothing (ModalityModule.forward's no_grad)
            with torch.set_grad_enabled(torch.is_grad_enabled() and (
                    x.requires_grad or not enc.frozen_module)):
                for i in range(sp.lo, sp.hi):
                    h = T.remat(cfg, functools.partial(
                        Mm._encoder_block, cfg, src.module.layers[str(i)],
                        pos), h)
                if not sp.last:
                    return F.pad(h.to(x.dtype), (0, dc - dm) + rows)
                h = L.apply_norm(cfg, src.module.final_ln, h)
            w1, w2 = src.projector.w1, src.projector.w2
            if enc.frozen_projector:
                w1 = w1.detach()
                w2 = None if w2 is None else w2.detach()
            out = h @ w1
            if w2 is not None:
                out = F.gelu(out, approximate="tanh") @ w2
            return F.pad(out.to(x.dtype), (0, dc - d_llm) + rows)
        return fn

    def make_llm_fn(sp: StageSpec):
        def fn(lp, x, mb):
            cfg = mllm.llm_cfg
            llm = lp.llm
            B, Tc, dc = x.shape
            bits, pos, emask, is_text = geometry(x.device)
            batch = {"positions": pos[None].expand(B, Tc),
                     "bits": bits[None].expand(B, Tc)}
            if sp.first:
                # modality rows of the carrier hold raw embeddings in
                # channel 0: the token read stays masked
                tokens = torch.where(is_text[None], mb[..., 0],
                                     0.0).long()
                h = llm.embed[tokens]
                if cfg.embed_scale:
                    h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
                h = torch.where(emask[None, :, None],
                                x[..., :cfg.d_model].to(h.dtype), h)
            else:
                h = x[..., :cfg.d_model].to(T.torch_dtype(cfg))
            for i in range(sp.lo, sp.hi):
                h, _ = T.remat(cfg, functools.partial(
                    T._block_out, cfg, llm.layers[str(i)], batch, i), h)
            if not sp.last:
                return F.pad(h.to(x.dtype), (0, dc - cfg.d_model))
            h = L.apply_norm(cfg, llm.final_ln, h)
            logits = T.unembed(llm, cfg, h).float()
            labels = torch.where(is_text[None], mb[..., 1], 0.0).long()
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, labels[..., None])[..., 0]
            nll = (lse - ll) * is_text[None].float()
            return F.pad(nll[..., None].to(x.dtype), (0, dc - 1))
        return fn

    fns = [make_encoder_fn(sp) if sp.kind == "encoder" else make_llm_fn(sp)
           for sp in specs]
    return StageBundle(
        mllm=mllm, specs=specs, stage_fns=fns, text_len=text_len,
        merged_len=total, d_carrier=d_carrier, bits_np=np.asarray(bits_np),
        pos_np=np.asarray(pos_np), emask_np=emask_np,
        is_text_np=is_text_np, text_pos_np=text_pos_np, slots=slots)
