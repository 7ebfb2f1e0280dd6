"""Whisper-base [arXiv:2212.04356] — enc-dec audio backbone; the
mel+conv frontend is stubbed (frame embeddings provided)."""
from repro_torch.configs.base import EncDecConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio", num_layers=6, d_model=512,
        num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=51865,
        head_dim=64, qkv_bias=True, act="gelu", norm="layernorm",
        tie_embeddings=True,
        encdec=EncDecConfig(num_encoder_layers=6, encoder_seq=1500),
        source="arXiv:2212.04356",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="whisper-base-reduced", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        encdec=EncDecConfig(num_encoder_layers=2, encoder_seq=64),
        dtype="float32", remat=False, seq_shard_activations=False,
        loss_chunk=0,
    )


register("whisper-base", full, reduced)
