"""phi-3-vision-4.2b — VLM: phi3-mini backbone + stub CLIP frontend
[hf:microsoft/Phi-3-vision-128k-instruct].  The ViT is a STUB per the
assignment carve-out: input_specs() provides (B, 576, 1024) patch embeddings;
the in-scope projector maps them into the decoder."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", arch_type="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064, rope=True, activation="swiglu",
    num_patches=576,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512, num_patches=16,
    param_dtype="float32", compute_dtype="float32", remat="none")
