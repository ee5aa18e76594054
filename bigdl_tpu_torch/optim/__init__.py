from .predictor import bucket_for

__all__ = ["bucket_for"]
