"""Model / run configuration schema (port of ``repro.configs.base``).

One frozen ``ModelConfig`` per architecture.  The fields and the analytic
parameter count are the reference's; ``param_dtype`` is a ``torch.dtype``.
``SHAPES`` is the reference's input-shape grid, kept as data.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # decoder | rglru_hybrid | rwkv6 | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # --- flavor options ---
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np (OLMo)
    mlp: str = "swiglu"            # swiglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4

    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    moe_dense_residual: bool = False
    capacity_factor: float = 1.25
    moe_dispatch: str = "global"
    moe_shard: str = "ep"

    # --- hybrid (RG-LRU) ---
    attn_period: int = 0
    window: int = 0
    d_rnn: int = 0
    conv_width: int = 4

    # --- rwkv6 ---
    rwkv_head_dim: int = 64

    # --- vlm ---
    mrope_sections: Tuple[int, ...] = ()

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500

    # --- quantization recipe (paper §3.4) ---
    quant_recipe: str = "all"      # all | hybrid | moe_hybrid

    # --- training knobs ---
    remat: str = "none"
    dtype: str = "bfloat16"

    skip_shapes: Tuple[str, ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def qkv_dim(self) -> int:
        return (self.n_heads + 2 * self.n_kv_heads) * self.head_dim

    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def n_params(self, active_only: bool = False) -> int:
        """Parameter count (analytic).  active_only: MoE counts top-k only."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        att = d * self.qkv_dim + self.n_heads * hd * d
        if self.qkv_bias:
            att += self.qkv_dim
        mlp = d * ff * (3 if self.mlp == "swiglu" else 2)
        if self.n_experts:
            n_e = self.experts_per_tok if active_only else self.n_experts
            mlp = n_e * (3 * d * self.moe_d_ff) + d * self.n_experts
            if self.shared_d_ff:
                mlp += 3 * d * self.shared_d_ff
            if self.moe_dense_residual:
                mlp += 3 * d * ff
        per_layer = att + mlp + 2 * d
        if self.family == "rglru_hybrid":
            n_attn = self.n_layers // self.attn_period
            n_rec = self.n_layers - n_attn
            rec = (2 * d * self.d_rnn + self.conv_width * self.d_rnn
                   + 2 * self.d_rnn + self.d_rnn * d) + mlp + 2 * d
            body = n_attn * (att + mlp + 2 * d) + n_rec * rec
        elif self.family == "rwkv6":
            tm = 4 * d * d + d * 160 + 5 * 32 * d + 2 * d * 64 + d
            cm = d * ff + ff * d
            body = self.n_layers * (tm + cm + 2 * d)
        elif self.family == "encdec":
            enc = self.n_enc_layers * (att + 2 * d * ff + 2 * d)
            dec = self.n_layers * (2 * att + 2 * d * ff + 3 * d)
            body = enc + dec
        else:
            body = self.n_layers * per_layer
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return body + emb + d
