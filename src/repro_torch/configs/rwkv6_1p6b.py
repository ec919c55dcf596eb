"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", arch_type="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536, rwkv_head_dim=64, rwkv_decay_lora=64,
    rope=False, activation="squared_relu",
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=128, d_ff=256, vocab_size=512, rwkv_head_dim=32,
    rwkv_decay_lora=16,
    param_dtype="float32", compute_dtype="float32", remat="none")
