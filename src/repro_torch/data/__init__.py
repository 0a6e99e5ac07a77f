from . import generated, pipeline
from .pipeline import DataConfig, domain_accuracy, eval_batches, make_batch

__all__ = ["generated", "pipeline", "DataConfig", "domain_accuracy",
           "eval_batches", "make_batch"]
