"""arctic-480b — MoE 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", arch_type="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=4864, expert_d_ff=4864, vocab_size=32000, rope=True,
    activation="swiglu",
    num_experts=128, top_k=2, capacity_factor=1.25,
    moe_dense_residual=True, dense_residual_d_ff=4864,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=128, expert_d_ff=128, dense_residual_d_ff=128, vocab_size=512,
    num_experts=4, top_k=2, capacity_factor=8.0,
    param_dtype="float32", compute_dtype="float32", remat="none")
