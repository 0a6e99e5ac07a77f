"""rwkv6-3b [ssm] — arXiv:2404.05892 (RWKV-6 "Finch" 3B).

32L, d_model 2560 (attention-free), d_ff 8960, vocab 65536.
Data-dependent per-channel decay (the Finch signature), head_dim 64
(40 wkv heads).  Chunk-parallel WKV on TPU (DESIGN.md §4).

long_500k RUNS: the wkv state is O(1) per layer.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="rwkv6-3b", family="rwkv6",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536, rwkv_head_dim=64,
    norm="layernorm", qkv_bias=False,
    tie_embeddings=False,
    quant_recipe="all",
    skip_shapes=(),
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke", family="rwkv6",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
    vocab_size=512, rwkv_head_dim=32, norm="layernorm",
)
