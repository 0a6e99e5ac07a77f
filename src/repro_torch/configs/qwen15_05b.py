"""qwen1.5-0.5b [dense] — hf: Qwen/Qwen1.5-0.5B.

24L, d_model 1024, 16 heads (kv=16), d_ff 2816, vocab 151936.
Signature: QKV bias, RMSNorm, SwiGLU, tied embeddings, rope_theta 1e6.
long_500k skipped: pure full attention.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="qwen1.5-0.5b", family="decoder",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936,
    norm="rmsnorm", mlp="swiglu", qkv_bias=True,
    tie_embeddings=True, rope_theta=1e6,
    quant_recipe="all", skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke", family="decoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
    vocab_size=512, qkv_bias=True, tie_embeddings=True,
)
