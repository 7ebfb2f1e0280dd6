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

    # family extras: the other families' sub-configs are objects in the
    # JAX package and unported here (ROADMAP.md item 20); the dense and
    # vlm families read only mm.mrope_sections
    moe: Any = None
    ssm: Any = None
    xlstm: Any = None
    encdec: Any = None
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
        """Parameters of the dense and vlm families (the ones the port
        runs), by the reference's formula."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ff = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        embed = V * d * (1 if self.tie_embeddings else 2)
        return int(L * (attn + ff) + embed)


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


def _ensure_imported() -> None:
    # config modules register themselves on import
    from repro_torch.configs import (  # noqa: F401
        gemma2_9b, qwen2_5_14b, qwen2_vl_7b, qwen3_1_7b, starcoder2_7b)
