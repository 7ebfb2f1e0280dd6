"""Gemma2-9B [arXiv:2408.00118] — local(4096)/global alternating
attention, attn+final logit softcaps, post-block norms, tied embeddings,
sqrt(d) embedding scale, head_dim 256."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense", num_layers=42, d_model=3584,
        num_heads=16, num_kv_heads=8, d_ff=14336, vocab_size=256000,
        head_dim=256, rope_theta=1e4, attn_softcap=50.0, final_softcap=30.0,
        sliding_window=4096, local_global_pattern=2, post_block_norm=True,
        tie_embeddings=True, embed_scale=True, act="gelu",
        decode_kv_replicate=16,
        source="arXiv:2408.00118",
    )


def long_context_variant() -> ModelConfig:
    """long_500k: all layers local sliding-window."""
    return full().replace(name="gemma2-9b-swa", local_global_pattern=0,
                          sliding_window=4096)


def reduced() -> ModelConfig:
    return full().replace(
        name="gemma2-9b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        sliding_window=16, dtype="float32", remat=False,
        seq_shard_activations=False, loss_chunk=0,
        decode_kv_replicate=4,   # valid for the 4-head reduced variant
    )


register("gemma2-9b", full, reduced)
