"""Model configs and the registry (the port's own copy of
``repro.configs.base``; field names are kept so configs read the same in
both packages).

In the port, ``attn_impl`` selects the prefill attention path:
``"xla"`` is the plain PyTorch dense path and ``"bam_kernel"`` the
hand-written CUDA BAM kernel (``repro_torch.kernels.ops``).
``"bam_interpret"`` has no counterpart and is rejected where attention
runs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN config (shared + routed experts)."""

    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_expert: int = 0           # per-expert FFN hidden size
    first_dense_layers: int = 0  # leading dense layers (deepseek-moe style)
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    backend: str = "capacity"    # capacity (fixed-capacity scatter) | dense
    expert_pad_to: int = 0       # pad E up to a multiple (dummy experts)

    @property
    def num_experts_padded(self) -> int:
        if not self.expert_pad_to:
            return self.num_experts
        m = self.expert_pad_to
        return ((self.num_experts + m - 1) // m) * m


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) config."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block-mix config."""

    slstm_at: Tuple[int, ...] = ()   # layer indices that are sLSTM; rest mLSTM
    proj_factor_m: float = 2.0       # mLSTM up-projection factor
    proj_factor_s: float = 4.0 / 3.0  # sLSTM FFN factor
    conv_kernel: int = 4
    chunk: int = 64                  # chunkwise-parallel mLSTM chunk length


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (whisper-style) extras."""

    num_encoder_layers: int = 0
    encoder_seq: int = 1500   # frames after the (stubbed) conv frontend
    max_source_positions: int = 1500


@dataclass(frozen=True)
class MultimodalConfig:
    """Multimodal (vlm) composition extras; the frontend is stubbed."""

    num_patches: int = 256        # image patch tokens fed to the backbone
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE: (t, h, w) dims
    modality_name: str = "vision"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    source: str = ""

    rope_theta: float = 1e4
    use_qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0
    local_global_pattern: int = 0
    tie_embeddings: bool = False
    act: str = "silu"
    norm: str = "rmsnorm"
    post_block_norm: bool = False
    embed_scale: bool = False

    # family extras
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    mm: Optional[MultimodalConfig] = None
    attn_layer_period: int = 0
    shared_attn: bool = False

    dtype: str = "bfloat16"
    remat: bool = True
    seq_shard_activations: bool = True
    loss_chunk: int = 1024
    attn_impl: str = "xla"        # xla | bam_kernel
    decode_kv_replicate: int = 0
    attn_q_chunk: int = 0
    # context parallelism: in the port cp_mesh holds the
    # torch.distributed.ProcessGroup of the CP ranks (the JAX package
    # holds a device mesh here); cp_axis names the mesh axis in JAX and
    # is unused by the port
    cp_mesh: Any = None
    cp_axis: str = "cp"
    cp_method: str = "allgather"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameters by the reference's analytic formula, for every
        family."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "moe" and self.moe is not None:
            m = self.moe
            ff_rout = 3 * d * m.d_expert * m.num_experts
            ff_shared = 3 * d * m.d_expert * m.num_shared_experts
            router = d * m.num_experts
            dense_ff = 3 * d * self.d_ff if m.first_dense_layers else 0
            n_moe = L - m.first_dense_layers
            layers = n_moe * (attn + ff_rout + ff_shared + router) + \
                m.first_dense_layers * (attn + dense_ff)
        elif self.family == "ssm":
            layers = L * self._xlstm_layer_params()
        elif self.family == "hybrid":
            ssm_p = self._mamba_layer_params()
            n_attn = (L // self.attn_layer_period) if self.attn_layer_period \
                else 0
            attn_p = attn + 3 * d * self.d_ff
            if self.shared_attn:
                layers = L * ssm_p + attn_p  # one shared block
            else:
                layers = L * ssm_p + n_attn * attn_p
        else:
            ff = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
            layers = L * (attn + ff)
            if self.encdec is not None:
                enc_attn = 4 * d * d
                enc_ff = 2 * d * self.d_ff
                cross = 4 * d * d
                layers += self.encdec.num_encoder_layers * (enc_attn + enc_ff)
                layers += L * cross  # decoder cross-attention
        embed = V * d * (1 if self.tie_embeddings else 2)
        return int(layers + embed)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-in experts)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        m = self.moe
        d, L = self.d_model, self.num_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ff_act = 3 * d * m.d_expert * (m.top_k + m.num_shared_experts)
        router = d * m.num_experts
        dense_ff = 3 * d * self.d_ff if m.first_dense_layers else 0
        n_moe = L - m.first_dense_layers
        layers = n_moe * (attn + ff_act + router) + \
            m.first_dense_layers * (attn + dense_ff)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(layers + embed)

    def _mamba_layer_params(self) -> int:
        s = self.ssm or SSMConfig()
        d = self.d_model
        di = s.d_inner(d)
        nh = s.n_heads(d)
        in_proj = d * (2 * di + 2 * s.d_state + nh)  # z,x,B,C,dt (grouped)
        conv = s.d_conv * (di + 2 * s.d_state)
        out = di * d
        return in_proj + conv + out + di + 2 * nh

    def _xlstm_layer_params(self) -> int:
        x = self.xlstm or XLSTMConfig()
        d = self.d_model
        dm = int(d * x.proj_factor_m)
        n_s = len(x.slstm_at)
        n_m = self.num_layers - n_s
        # mLSTM: up + gate-up, q/k/v, down (i/f gates are [dm, nh]: tiny)
        m = 2 * d * dm + 3 * dm * dm + dm * d
        # sLSTM: zifo input weights, block-diag recurrent, gated FFN
        dff = int(d * x.proj_factor_s)
        hd = d // max(self.num_heads, 1)
        sl = 4 * d * d + 4 * hd * d + 3 * d * dff
        return int((m * n_m + sl * n_s) / max(self.num_layers, 1))


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_imported()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    _ensure_imported()
    return sorted(_REGISTRY)


def _ensure_imported() -> None:
    # config modules register themselves on import
    from repro_torch.configs import (  # noqa: F401
        deepseek_moe_16b, gemma2_9b, qwen2_5_14b, qwen2_moe_a2_7b,
        qwen2_vl_7b, qwen3_1_7b, starcoder2_7b, whisper_base, xlstm_125m,
        zamba2_2_7b)


# Which (arch, shape) pairs are skipped and why (the reference's
# long_500k policy: only sub-quadratic archs run it).
LONG_CONTEXT_OK = {"zamba2-2.7b", "xlstm-125m", "gemma2-9b"}

SKIPS: dict[tuple[str, str], str] = {
    (a, "long_500k"):
        "pure full-attention arch; no sub-quadratic variant (DESIGN.md)"
    for a in (
        "starcoder2-7b", "qwen3-1.7b", "qwen2.5-14b", "qwen2-vl-7b",
        "whisper-base", "qwen2-moe-a2.7b", "deepseek-moe-16b",
    )
}


def pair_skip_reason(arch: str, shape: str) -> Optional[str]:
    return SKIPS.get((arch, shape))
