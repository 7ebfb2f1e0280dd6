"""The paper's own evaluation model zoo (Table 1): Llama-3.1-style LLMs,
EVA-CLIP-style vision encoders and Whisper-style audio encoders in
S/M/L. ``llm_config("M")`` has Llama-3.1-8B widths. Encoders are modelled
as bidirectional transformer backbones over stubbed frame/patch
embeddings (``models/mllm.py``)."""
from repro_torch.configs.base import ModelConfig

# Table 1: (layers, hidden) per size
_LLM = {"S": (16, 2048), "M": (32, 4096), "L": (64, 5120)}
_VISION = {"S": (40, 1408), "M": (32, 4096), "L": (48, 5120)}
_AUDIO = {"S": (32, 1920), "M": (40, 3840), "L": (48, 5120)}


def llm_config(size: str = "M", reduced: bool = False) -> ModelConfig:
    L, d = _LLM[size]
    cfg = ModelConfig(
        name=f"paper-llama-{size}", family="dense", num_layers=L, d_model=d,
        num_heads=max(d // 128, 1), num_kv_heads=max(d // 512, 1),
        d_ff=int(3.5 * d), vocab_size=128256, head_dim=128,
        rope_theta=5e5, source="arXiv:2407.21783 (Llama 3.1 herd)",
    )
    if reduced:
        cfg = cfg.replace(num_layers=2, d_model=256, num_heads=4,
                          num_kv_heads=2, head_dim=64, d_ff=512,
                          vocab_size=512, dtype="float32", remat=False,
                          seq_shard_activations=False, loss_chunk=0)
    return cfg


def _encoder_config(name: str, L: int, d: int, unit: int, source: str,
                    reduced: bool) -> ModelConfig:
    """Heads of ``unit`` width where d divides by it (EVA-CLIP 88,
    Whisper 96), else d split evenly over d // unit heads."""
    heads = max(d // unit, 1)
    cfg = ModelConfig(
        name=name, family="dense", num_layers=L, d_model=d, num_heads=heads,
        num_kv_heads=heads, head_dim=unit if d % unit == 0 else d // heads,
        d_ff=4 * d, vocab_size=1, norm="layernorm", act="gelu",
        source=source,
    )
    if reduced:
        cfg = cfg.replace(num_layers=2, d_model=128, num_heads=2,
                          num_kv_heads=2, head_dim=64, d_ff=256,
                          dtype="float32", remat=False,
                          seq_shard_activations=False)
    return cfg


def vision_encoder_config(size: str = "M", reduced: bool = False):
    """EVA-CLIP-style ViT encoder backbone widths (patch embeds stubbed)."""
    L, d = _VISION[size]
    return _encoder_config(f"paper-evaclip-{size}", L, d, 88,
                           "arXiv:2303.15389 (EVA-CLIP)", reduced)


def audio_encoder_config(size: str = "M", reduced: bool = False):
    """Whisper-style audio encoder backbone widths (conv codec stubbed)."""
    L, d = _AUDIO[size]
    return _encoder_config(f"paper-whisper-{size}", L, d, 96,
                           "arXiv:2212.04356 (Whisper)", reduced)
