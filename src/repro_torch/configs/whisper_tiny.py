"""whisper-tiny [audio] — arXiv:2212.04356.

Enc-dec transformer backbone; the conv/mel frontend is a STUB
(``input_specs`` feeds precomputed frame embeddings [B, 1500, 384]).
4 enc + 4 dec layers, d_model 384, 6 heads (kv=6), d_ff 1536, vocab 51865.
LayerNorm + GELU + biases + tied embeddings, sinusoidal positions.

vocab 51865 is not divisible by the model axis (16): the sharding rules
leave the vocab dim unsharded (fallback) — at 20M params this is free.
Decode shapes run against the decoder self-attn cache; long_500k skipped
(full attention).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, enc_seq=1500,
    norm="layernorm", mlp="gelu", qkv_bias=True,
    tie_embeddings=True,
    quant_recipe="all", skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, enc_seq=30,
    norm="layernorm", mlp="gelu", qkv_bias=True, tie_embeddings=True,
)
