"""qwen3-moe-30b-a3b — MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", arch_type="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, expert_d_ff=768, vocab_size=151936, qk_norm=True, rope=True,
    rope_theta=1e6, activation="swiglu",
    num_experts=128, top_k=8, capacity_factor=1.25,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=128, expert_d_ff=128, vocab_size=512, num_experts=4, top_k=2, capacity_factor=8.0,
    param_dtype="float32", compute_dtype="float32", remat="none")
