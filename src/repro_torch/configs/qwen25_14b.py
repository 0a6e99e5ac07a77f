"""qwen2.5-14b [dense] — hf: Qwen/Qwen2.5-14B.

48L, d_model 5120, 40 heads (GQA kv=8), d_ff 13824, vocab 152064.
Signature: GQA + QKV bias.  40 heads do NOT divide the model axis (16):
the sharding rules fall back to sharding the fused QKV output dim
(7168 % 16 == 0) — see repro/distributed/sharding.py.
long_500k skipped: pure full attention.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="qwen2.5-14b", family="decoder",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab_size=152064,
    norm="rmsnorm", mlp="swiglu", qkv_bias=True,
    tie_embeddings=False, rope_theta=1e6,
    quant_recipe="all", skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke", family="decoder",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, d_ff=96,
    vocab_size=512, qkv_bias=True,
)
