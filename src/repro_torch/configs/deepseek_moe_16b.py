"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained 64 routed experts
top-6 + 2 shared experts, first layer dense."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=10944, vocab_size=102400,
        head_dim=128, rope_theta=1e4,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                      d_expert=1408, first_dense_layers=1),
        source="arXiv:2401.06066",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="deepseek-moe-16b-reduced", num_layers=3, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                      d_expert=128, first_dense_layers=1, backend="dense"),
        dtype="float32", remat=False, seq_shard_activations=False,
        loss_chunk=0,
    )


register("deepseek-moe-16b", full, reduced)
