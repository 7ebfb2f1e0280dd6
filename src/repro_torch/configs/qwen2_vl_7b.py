"""Qwen2-VL-7B language backbone [arXiv:2409.12191] — M-RoPE, dynamic
resolution (vision ViT stubbed: patch embeddings provided)."""
from repro_torch.configs.base import ModelConfig, MultimodalConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
        num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
        head_dim=128, rope_theta=1e6, qkv_bias=True,
        mm=MultimodalConfig(num_patches=1024, mrope_sections=(16, 24, 24),
                            modality_name="vision"),
        source="arXiv:2409.12191",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="qwen2-vl-7b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        mm=MultimodalConfig(num_patches=16, mrope_sections=(8, 12, 12),
                            modality_name="vision"),
        dtype="float32", remat=False, seq_shard_activations=False,
        loss_chunk=0,
    )


register("qwen2-vl-7b", full, reduced)
