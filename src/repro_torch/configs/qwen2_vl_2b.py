"""qwen2-vl-2b [vlm] — arXiv:2409.12191 (hf: Qwen/Qwen2-VL-2B).

Backbone only (the ViT frontend is a STUB: ``input_specs`` provides
precomputed patch embeddings + a splice mask).  28L, d_model 1536,
12 heads (GQA kv=2, head_dim 128), d_ff 8960, vocab 151936.
Signature: M-RoPE with (t,h,w) sections (16,24,24) over the 64 freq slots.
long_500k skipped: pure full attention.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="qwen2-vl-2b", family="decoder",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab_size=151936,
    mrope_sections=(16, 24, 24),
    norm="rmsnorm", mlp="swiglu", qkv_bias=True,
    tie_embeddings=True, rope_theta=1e6,
    quant_recipe="all", skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke", family="decoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=512, mrope_sections=(8, 4, 4), qkv_bias=True,
    tie_embeddings=True,
)
