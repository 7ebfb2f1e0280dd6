"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts
top-4 + 4 shared experts, fine-grained d_expert=1408."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=151936,
        head_dim=128, rope_theta=1e6,
        # expert_pad_to=64: four dummy experts pad E to a multiple of 16
        # (an expert-parallel width); the router only ever routes to the
        # real 60
        moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4,
                      d_expert=1408, expert_pad_to=64),
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="qwen2-moe-a2.7b-reduced", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                      d_expert=128, backend="dense"),
        dtype="float32", remat=False, seq_shard_activations=False,
        loss_chunk=0,
    )


register("qwen2-moe-a2.7b", full, reduced)
