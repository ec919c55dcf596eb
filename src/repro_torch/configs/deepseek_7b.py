"""deepseek-7b — dense llama-arch [arXiv:2401.02954]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", arch_type="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400, rope=True, activation="swiglu",
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512,
    param_dtype="float32", compute_dtype="float32", remat="none")
