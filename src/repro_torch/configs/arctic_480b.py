"""arctic-480b [moe] — hf: Snowflake/snowflake-arctic-base.

35L, d_model 7168, 56 heads (GQA kv=8), vocab 32000.
MoE: 128 experts, top-2, expert d_ff 4864, PLUS a parallel dense residual
FFN (d_ff 4864) on every layer — the Arctic "dense-MoE hybrid".
Experts shard 128/16 = 8-way per chip over the model axis (EP).
long_500k skipped: pure full attention.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="decoder",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    n_experts=128, experts_per_tok=2, moe_d_ff=4864,
    moe_dense_residual=True, capacity_factor=1.25,
    # §Perf M4: local dispatch + TP-inside-experts (EP resharding of the
    # dispatched tokens was measured collective-catastrophic; local+tp
    # halves compute waste at equal step time)
    moe_dispatch="local", moe_shard="tp",
    norm="rmsnorm", mlp="swiglu", qkv_bias=False,
    tie_embeddings=False, rope_theta=1e4,
    quant_recipe="moe_hybrid",        # paper: MoE models keep attn BF16 + FP8 KV
    skip_shapes=("long_500k",),
    remat="full",
)

SMOKE = ModelConfig(
    name="arctic-480b-smoke", family="decoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=512, n_experts=8, experts_per_tok=2, moe_d_ff=48,
    moe_dense_residual=True, quant_recipe="moe_hybrid",
    # drop-free capacity so decode == teacher-forcing exactly (token
    # dropping is seq-length dependent and breaks consistency checks)
    capacity_factor=8.0,
)
