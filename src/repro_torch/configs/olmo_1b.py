"""olmo-1b [dense] — arXiv:2402.00838 (hf: allenai/OLMo-1B).

16L, d_model 2048, 16 heads (GQA kv=16 == MHA), d_ff 8192, vocab 50304.
Signature: NON-PARAMETRIC LayerNorm, SwiGLU, tied embeddings, no biases.
long_500k skipped: pure full attention (DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="olmo-1b", family="decoder",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm="layernorm_np", mlp="swiglu", qkv_bias=False,
    tie_embeddings=True, rope_theta=1e4,
    quant_recipe="all", skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="olmo-1b-smoke", family="decoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, norm="layernorm_np", mlp="swiglu", tie_embeddings=True,
)
