"""nemotron-nano-9b-sim — the paper's selective-quantization flagship
(NVIDIA Nemotron Nano 9B V2, arXiv:2508.14444), *simulated*.

The real model is a Mamba2-Transformer hybrid (52 Mamba + 4 attention
layers).  This container has no Mamba2; the RG-LRU recurrent block is the
closest TPU-native linear-recurrence stand-in (DESIGN.md §3), so the sim
uses 56 layers with attn_period=14 -> 4 full-attention layers at the same
positions-per-ratio.  d_model 4480, 32 q heads / 8 kv (head_dim 128),
d_ff 15680, vocab 131072.

Quant recipe "hybrid" — the paper's §3.4 rule for this model: attention
layers + first/last-2 layers stay BF16.  long_500k skipped (the 4 attention
layers are full-attention; the real model's context is 128k).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="nemotron-nano-9b-sim", family="rglru_hybrid",
    n_layers=56, d_model=4480, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=15680, vocab_size=131072,
    attn_period=14, window=0, d_rnn=4480, conv_width=4,
    norm="rmsnorm", mlp="swiglu", qkv_bias=False,
    tie_embeddings=False, rope_theta=1e4,
    quant_recipe="hybrid", skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="nemotron-nano-9b-sim-smoke", family="rglru_hybrid",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, attn_period=3, window=0, d_rnn=64,
    quant_recipe="hybrid",
)
