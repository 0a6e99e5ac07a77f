"""acereason-7b — the paper's main ablation model (AceReason Nemotron 1.1
7B, arXiv:2506.13284), a Qwen2.5-7B-based RL-heavy reasoner.

Not part of the assigned pool — included because it is the paper's primary
experimental vehicle (Tables 3b/4/5/6/8): 28L, d_model 3584, 28 heads
(GQA kv=4), d_ff 18944, vocab 152064, QKV bias.
Quant recipe "all" (paper quantizes every GEMM for this model);
QAD LR 1e-5 (Table 6: RL-heavy models want LRs above typical RL rates).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="acereason-7b", family="decoder",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    norm="rmsnorm", mlp="swiglu", qkv_bias=True,
    tie_embeddings=False, rope_theta=1e6,
    quant_recipe="all", skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="acereason-7b-smoke", family="decoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, qkv_bias=True,
)
