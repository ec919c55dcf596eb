"""nemotron-4-340b — dense, GQA + squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", arch_type="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000, rope=True, activation="squared_relu",
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=1024, vocab_size=512,
    param_dtype="float32", compute_dtype="float32", remat="none")
