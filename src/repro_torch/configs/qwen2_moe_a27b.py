"""qwen2-moe-a2.7b [moe] — hf: Qwen/Qwen1.5-MoE-A2.7B.

24L, d_model 2048, 16 heads (kv=16), vocab 151936.
MoE: 60 routed experts top-4 (expert d_ff 1408) + shared expert
(d_ff 4x1408 = 5632) with a sigmoid gate.  60 experts do NOT divide the
model axis (16) — the rules fall back to TP *inside* the expert GEMMs
(1408 % 16 == 0).
long_500k skipped: pure full attention.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="qwen2-moe-a2.7b", family="decoder",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    n_experts=60, experts_per_tok=4, moe_d_ff=1408, shared_d_ff=5632,
    capacity_factor=1.25,
    # §Perf M3: batched-local dispatch — 12.9x step-time win vs the
    # global-sort baseline (EXPERIMENTS.md); baseline reproducible with
    # --moe-dispatch global
    moe_dispatch="local",
    norm="rmsnorm", mlp="swiglu", qkv_bias=True,
    tie_embeddings=False, rope_theta=1e6,
    quant_recipe="all", skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="decoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48,
    vocab_size=512, n_experts=6, experts_per_tok=2, moe_d_ff=48,
    shared_d_ff=96, qkv_bias=True,
)
