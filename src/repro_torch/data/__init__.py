from . import pipeline
from .pipeline import DataConfig, domain_accuracy, eval_batches, make_batch

__all__ = ["pipeline", "DataConfig", "domain_accuracy", "eval_batches",
           "make_batch"]
