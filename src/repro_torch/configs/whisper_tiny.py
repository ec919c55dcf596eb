"""whisper-tiny — encoder-decoder audio backbone [arXiv:2212.04356].

Mel-spectrogram + conv frontend is a STUB per the assignment carve-out:
input_specs() provides (B, 1500, 384) precomputed frame embeddings.
Positional encoding adapted to RoPE (TPU-native framework default; the
original uses learned/sinusoidal)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", arch_type="audio",
    num_layers=4, num_encoder_layers=4, encoder_seq=1500,
    d_model=384, num_heads=6, num_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865, rope=True, activation="gelu",
)

SMOKE = CONFIG.with_(
    num_layers=2, num_encoder_layers=2, encoder_seq=64,
    d_model=128, num_heads=2, num_kv_heads=2, head_dim=64,
    d_ff=256, vocab_size=512,
    param_dtype="float32", compute_dtype="float32", remat="none")
