"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", arch_type="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    hybrid_attn_every=6, activation="swiglu", rope=True,
)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512, hybrid_attn_every=2, ssm_chunk=32,
    param_dtype="float32", compute_dtype="float32", remat="none")
