"""qwen3-1.7b — dense, GQA + qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", arch_type="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936, qk_norm=True, rope=True,
    rope_theta=1e6, activation="swiglu",
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
    param_dtype="float32", compute_dtype="float32", remat="none")
