"""recurrentgemma-2b [hybrid] — arXiv:2402.19427 (Griffin).

26L, d_model 2560, 10 heads (MQA kv=1, head_dim 256), d_ff 7680,
vocab 256000.  Pattern 1:2 — every third layer is LOCAL attention
(window 2048), the rest are RG-LRU recurrent blocks (d_rnn 2560,
conv width 4).  26 = 8 super-blocks of (2 rec + 1 attn) + 2 remainder
recurrent layers.

long_500k RUNS for this arch: RG-LRU state is O(1) and local attention
caches only `window` positions — sub-quadratic end to end.
Quant recipe: the paper's hybrid rule (attention + first/last-2 BF16).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="recurrentgemma-2b", family="rglru_hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab_size=256000,
    attn_period=3, window=2048, d_rnn=2560, conv_width=4,
    norm="rmsnorm", mlp="swiglu", qkv_bias=False,
    tie_embeddings=True, rope_theta=1e4,
    quant_recipe="hybrid",
    skip_shapes=(),
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="rglru_hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=512, attn_period=3, window=16, d_rnn=64,
    tie_embeddings=True, quant_recipe="hybrid",
)
