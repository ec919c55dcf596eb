"""Model configuration for all supported architecture families.

A copy of the JAX package's ``models/config.py`` (the port imports nothing
from it): one dataclass covers the six arch types dense / moe / ssm /
hybrid / vlm / audio.  Fields unused by a family are ignored by its
model code.  ``use_flash_kernel``, ``use_paged_kernel`` and
``use_ssd_kernel`` select the hand-written CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio

    # core transformer dims
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1000

    # attention flavour
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    attention_kind: str = "full"  # full | sliding_window
    sliding_window: int = 4096
    # q-chunked attention: the scores of attn_q_chunk query rows at a
    # time, so the (S,T) score matrix never exists whole.  0 = off.
    attn_q_chunk: int = 0
    # batched attention through kernels.ops.flash_attention: the CUDA
    # kernel for CUDA tensors, its plain version for CPU tensors.
    use_flash_kernel: bool = False
    # block-table decode reads through kernels.ops.paged_attention: the
    # CUDA kernel for CUDA tensors, its plain version for CPU tensors.
    use_paged_kernel: bool = False
    # value used by serve_step for the decode KV cache length; overridden by
    # the input shape at lowering time.
    max_cache_len: int = 2048

    # MLP flavour
    activation: str = "swiglu"  # swiglu | squared_relu | gelu

    # MoE
    num_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0  # per-expert hidden; 0 -> d_ff
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    dense_residual_d_ff: int = 0  # 0 -> d_ff
    # routing groups: 0 = auto (one group per sequence; shards over the
    # data axis — EXPERIMENTS.md §Perf iteration 1).  1 = the survey-era
    # single global group (paper-faithful baseline; replicates dispatch).
    moe_groups: int = 0

    # SSM (Mamba2 / SSD)
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # the prefill's SSD chunk scan through kernels.ops.ssd_scan: the CUDA
    # kernel for CUDA tensors, its plain version for CPU tensors.  Off, the
    # plain chunked math runs, as in the JAX model (which never calls its
    # Pallas ssd_scan).
    use_ssd_kernel: bool = False

    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # hybrid (Zamba2-style): a shared attention+MLP block applied after every
    # `hybrid_attn_every` SSM layers, reusing the SAME weights each time.
    hybrid_attn_every: int = 6

    # encoder-decoder (Whisper backbone)
    num_encoder_layers: int = 0
    encoder_seq: int = 1500  # precomputed frame embeddings (stub frontend)

    # VLM (Phi-3-vision backbone): precomputed patch embeddings (stub ViT)
    num_patches: int = 0  # >0 -> vlm inputs carry patch embeddings

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # remat: 'none' | 'block' (checkpoint each scanned block)
    remat: str = "block"
    # fully unroll the layer scan (dry-run only: XLA's HloCostAnalysis counts
    # a while-loop body once, so FLOPs under scan are under-reported)
    unroll_layers: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.expert_d_ff == 0:
            object.__setattr__(self, "expert_d_ff", self.d_ff)
        if self.moe_dense_residual and self.dense_residual_d_ff == 0:
            object.__setattr__(self, "dense_residual_d_ff", self.d_ff)

    # ---- derived quantities -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_sub_quadratic(self) -> bool:
        """Can this config serve extremely long contexts (O(1)/O(window) state)?"""
        return self.arch_type in ("ssm", "hybrid") or (
            self.arch_type in ("dense", "moe", "vlm")
            and self.attention_kind == "sliding_window"
        )

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def param_count(cfg: ModelConfig) -> Tuple[int, int]:
    """Analytic (total, active) parameter counts (embeddings included)."""
    d, ff = cfg.d_model, cfg.d_ff
    emb = cfg.vocab_size * d * 2  # embed + untied lm head
    per_layer_total = 0
    per_layer_active = 0

    def attn_params():
        return d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d

    def mlp_params(h):
        n = 2 * d * h + h * d if cfg.activation == "swiglu" else 2 * d * h
        return n

    if cfg.arch_type in ("dense", "vlm", "audio"):
        per_layer_total = attn_params() + mlp_params(ff) + 2 * d
        per_layer_active = per_layer_total
        total = emb + cfg.num_layers * per_layer_total
        active = emb + cfg.num_layers * per_layer_active
        if cfg.arch_type == "audio" and cfg.num_encoder_layers:
            enc = cfg.num_encoder_layers * (attn_params() + mlp_params(ff) + 2 * d)
            dec_cross = cfg.num_layers * attn_params()  # cross-attention
            total += enc + dec_cross
            active += enc + dec_cross
        return total, active

    if cfg.arch_type == "moe":
        e_ff = cfg.expert_d_ff
        expert = mlp_params(e_ff)
        router = d * cfg.num_experts
        per_layer_total = attn_params() + router + cfg.num_experts * expert + 2 * d
        per_layer_active = attn_params() + router + cfg.top_k * expert + 2 * d
        if cfg.moe_dense_residual:
            dr = mlp_params(cfg.dense_residual_d_ff)
            per_layer_total += dr
            per_layer_active += dr
        return emb + cfg.num_layers * per_layer_total, emb + cfg.num_layers * per_layer_active

    if cfg.arch_type == "ssm":
        # rwkv6-style: time-mix (5 square-ish mats) + channel-mix
        tm = 4 * d * d + d * d  # r,k,v,g,o
        lora = 2 * d * cfg.rwkv_decay_lora
        cm = d * ff + ff * d
        per_layer_total = tm + lora + cm + 2 * d
        return emb + cfg.num_layers * per_layer_total, emb + cfg.num_layers * per_layer_total

    if cfg.arch_type == "hybrid":
        din = cfg.ssm_d_inner
        in_proj = d * (2 * din + 2 * cfg.ssm_state + cfg.ssm_heads)
        out_proj = din * d
        mamba = in_proj + out_proj + din  # + small conv/decay terms
        shared = attn_params() + mlp_params(ff) + 2 * d
        total = emb + cfg.num_layers * (mamba + 2 * d) + shared
        return total, total

    raise ValueError(cfg.arch_type)
