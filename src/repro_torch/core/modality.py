"""Modular MLLM construction (Cornstarch §3.2): ``ModalityModule`` and
``MultimodalModule``, the counterpart of ``repro.core.modality``.

    vis  = ModalityModule("vision", vis_cfg, modality_id=1)
    mllm = MultimodalModule(encoders={"vision": vis}, llm_cfg=llm_cfg)
    mllm.freeze("vision", module=True, projector=False)
    params = mllm.init(device="cuda", generator=gen)   # an nn.Module
    (logits, aux), merged = mllm.forward(params, batch)

The parameters are one ``MLLMParams`` module whose names follow the JAX
tree: ``encoders.<name>.module`` (the encoder), ``encoders.<name>
.projector.w1`` (and ``w2``), ``llm``. Frozen parts hold
``requires_grad=False`` (``apply_freeze``), and a frozen encoder runs
under ``torch.no_grad()``: the analogues of the JAX package's
``stop_gradient``, so the backward never enters them. The execution
graph, ``ParallelSpec`` and ``profiles()`` come with the pipeline slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bam
from repro_torch.models import layers as Lyr
from repro_torch.models import mllm as M
from repro_torch.models import transformer as T

Callback = Callable[..., Any]


class Projector(nn.Module):
    """``out @ w1`` (linear), or ``gelu(out @ w1) @ w2`` (mlp)."""

    def __init__(self, kind: str, d: int, llm_d: int, dtype, device,
                 generator):
        super().__init__()
        self.w1 = Lyr.normal_param((d, llm_d), dtype, device, generator)
        self.w2 = Lyr.normal_param((llm_d, llm_d), dtype, device,
                                   generator) if kind == "mlp" else None


class ModalityParams(nn.Module):
    def __init__(self, module: nn.Module, projector: Projector):
        super().__init__()
        self.module = module
        self.projector = projector


class MLLMParams(nn.Module):
    def __init__(self, encoders: Dict[str, ModalityParams], llm: nn.Module):
        super().__init__()
        self.encoders = nn.ModuleDict(encoders)
        self.llm = llm


@dataclasses.dataclass
class ModalityModule:
    """One unimodal model + its projector into the LLM embedding space.
    The modality frontend is stubbed: the module consumes precomputed
    frame/patch embeddings."""
    name: str
    cfg: ModelConfig
    modality_id: int                      # BAM bit (1..15; 0 = text)
    projector: str = "linear"             # linear | mlp
    num_tokens: int = 0                   # tokens this encoder emits
    frozen_module: bool = True
    frozen_projector: bool = False
    preprocess_callback: Optional[Callback] = None
    postprocess_module_callback: Optional[Callback] = None
    postprocess_projector_callback: Optional[Callback] = None

    def init(self, llm_d_model: int, *, device="cuda",
             generator=None) -> ModalityParams:
        if self.projector not in ("linear", "mlp"):
            raise ValueError(f"projector={self.projector!r}")
        module = M.encoder_init(self.cfg, device=device, generator=generator)
        dev = next(module.parameters()).device
        proj = Projector(self.projector, self.cfg.d_model, llm_d_model,
                         T.torch_dtype(self.cfg), dev, generator)
        return ModalityParams(module, proj)

    def forward(self, params: ModalityParams, inputs):
        """inputs: dict with f"{name}_embeds" [B, T_m, d_m]. The call
        order of Listing 2: cb_before -> module -> cb_after -> projector
        -> cb_after_proj. A frozen encoder runs without autograd."""
        if self.preprocess_callback:
            inputs = self.preprocess_callback(inputs)
        embeds = inputs[f"{self.name}_embeds"]
        if self.frozen_module:
            with torch.no_grad():
                out = M.encoder_forward(params.module, self.cfg, embeds)
        else:
            out = M.encoder_forward(params.module, self.cfg, embeds)
        if self.postprocess_module_callback:
            out = self.postprocess_module_callback(inputs, out)
        w1, w2 = params.projector.w1, params.projector.w2
        if self.frozen_projector:
            w1 = w1.detach()
            w2 = None if w2 is None else w2.detach()
        out = out @ w1
        if w2 is not None:
            out = F.gelu(out, approximate="tanh") @ w2
        if self.postprocess_projector_callback:
            out = self.postprocess_projector_callback(inputs, out)
        return out


@dataclasses.dataclass
class MultimodalModule:
    encoders: Dict[str, ModalityModule]
    llm_cfg: ModelConfig
    frozen_llm: bool = True
    # merge policy: list of segments ("text", n) | (encoder_name,)
    layout: Optional[List[Tuple]] = None
    preprocess_callback: Optional[Callback] = None   # cb_before_llm

    def __post_init__(self):
        ids = [e.modality_id for e in self.encoders.values()]
        if len(set(ids)) != len(ids) or 0 in ids:
            raise ValueError(f"modality ids must be unique and nonzero: {ids}")

    # -- freezing ------------------------------------------------------------
    def freeze(self, name: str, *, module: Optional[bool] = None,
               projector: Optional[bool] = None):
        if name == "llm":
            if module is None:
                raise ValueError("freeze('llm') needs module=")
            self.frozen_llm = module
            return
        e = self.encoders[name]
        if module is not None:
            e.frozen_module = module
        if projector is not None:
            e.frozen_projector = projector

    # -- params ---------------------------------------------------------------
    def init(self, *, device="cuda", generator=None) -> MLLMParams:
        """Random weights, encoders in name order then the LLM, drawn from
        ``generator``; frozen parts get ``requires_grad=False``."""
        encs = {name: enc.init(self.llm_cfg.d_model, device=device,
                               generator=generator)
                for name, enc in sorted(self.encoders.items())}
        params = MLLMParams(encs, T.init(self.llm_cfg, device=device,
                                         generator=generator))
        self.apply_freeze(params)
        return params

    def frozen_mask(self, params: MLLMParams) -> Dict[str, bool]:
        """{parameter name: True if frozen (no optimizer update)}."""
        mask = {}
        for name, _ in params.named_parameters():
            parts = name.split(".")
            if parts[0] == "llm":
                mask[name] = self.frozen_llm
            else:
                enc = self.encoders[parts[1]]
                mask[name] = (enc.frozen_module if parts[2] == "module"
                              else enc.frozen_projector)
        return mask

    def apply_freeze(self, params: MLLMParams) -> None:
        """requires_grad = not frozen, for every parameter."""
        mask = self.frozen_mask(params)
        for name, p in params.named_parameters():
            p.requires_grad_(not mask[name])

    # -- batch merge (cb_before_llm default policy) ---------------------------
    def default_layout(self, text_len: int) -> List[Tuple]:
        """EE-style: text prefix, then each encoder stream, then the
        remaining text (encoder outputs embedded, Fig. 11b)."""
        n_enc = len(self.encoders)
        pre = max(text_len // (n_enc + 1), 1)
        lay: List[Tuple] = [("text", pre)]
        rest = text_len - pre
        for name in sorted(self.encoders):
            lay.append((name,))
            lay.append(("text", max(rest // n_enc, 0)))
        used = sum(s[1] for s in lay if s[0] == "text")
        if used < text_len:
            lay.append(("text", text_len - used))
        return lay

    def merged_length(self, text_len: int) -> int:
        return text_len + sum(e.num_tokens for e in self.encoders.values())

    def build_merge(self, text_tokens, enc_outputs: Dict[str, Any],
                    layout: Optional[List[Tuple]] = None):
        """Merge text tokens and projected encoder outputs into one
        sequence: a transformer batch (inputs_embeds path) with BAM bits
        and positions. Segment offsets are host logic (static layout);
        the embeds are concatenated, so gradients reach each encoder
        output."""
        B, Tt = text_tokens.shape
        dev = text_tokens.device
        layout = layout or self.layout or self.default_layout(Tt)
        total = self.merged_length(Tt)
        d = self.llm_cfg.d_model
        dtype = T.torch_dtype(self.llm_cfg)

        segs, t_used = [], 0
        for seg in layout:
            if seg[0] == "text":
                segs.append(("text", 0, seg[1]))
                t_used += seg[1]
            else:
                enc = self.encoders[seg[0]]
                segs.append(("mod", enc.modality_id, enc.num_tokens))
        if t_used != Tt:
            raise ValueError(f"layout holds {t_used} text tokens, batch {Tt}")
        bits_np, pos_np = bam.build_sample_bits(segs, total)
        bits = torch.from_numpy(bits_np).to(dev)[None].repeat(B, 1)
        positions = torch.from_numpy(pos_np).to(dev)[None].repeat(B, 1)

        toks, embeds, emask = [], [], []
        t_off = 0
        for seg in layout:
            if seg[0] == "text":
                n = seg[1]
                toks.append(text_tokens[:, t_off:t_off + n])
                embeds.append(torch.zeros((B, n, d), dtype=dtype, device=dev))
                t_off += n
            else:
                n = self.encoders[seg[0]].num_tokens
                toks.append(torch.zeros((B, n), dtype=text_tokens.dtype,
                                        device=dev))
                embeds.append(enc_outputs[seg[0]].to(dtype))
            emask.append(torch.full((B, n), seg[0] != "text",
                                    dtype=torch.bool, device=dev))
        return {"tokens": torch.cat(toks, 1), "positions": positions,
                "bits": bits, "inputs_embeds": torch.cat(embeds, 1),
                "embed_mask": torch.cat(emask, 1)}

    # -- single-program forward ----------------------------------------------
    def forward(self, params: MLLMParams, batch):
        """Returns ((logits [B,T,V], aux), merged batch)."""
        enc_out = {}
        for name, enc in sorted(self.encoders.items()):
            enc_out[name] = enc.forward(params.encoders[name], batch)
        merged = self.build_merge(batch["text_tokens"], enc_out)
        if self.preprocess_callback:
            merged = self.preprocess_callback(enc_out, merged)
        return T.forward(params.llm, self.llm_cfg, merged), merged
