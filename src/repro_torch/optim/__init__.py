from .adamw import AdamW, AdamWState, constant, warmup_cosine
from .compression import CompressionState, Int8Compressor

__all__ = ["AdamW", "AdamWState", "CompressionState", "Int8Compressor",
           "constant", "warmup_cosine"]
