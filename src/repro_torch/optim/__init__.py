from .adamw import AdamW, AdamWState, constant, warmup_cosine

__all__ = ["AdamW", "AdamWState", "constant", "warmup_cosine"]
