"""granite-34b [dense] — arXiv:2405.04324 (IBM Granite Code 34B).

88L, d_model 6144, 48 heads (MQA: kv=1), d_ff 24576, vocab 49152.
Llama-style blocks; multi-query attention (kv heads replicated under TP).
long_500k skipped: pure full attention.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="granite-34b", family="decoder",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    norm="rmsnorm", mlp="swiglu", qkv_bias=False,
    tie_embeddings=False, rope_theta=1e4,
    quant_recipe="all", skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="granite-34b-smoke", family="decoder",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=512,
)
