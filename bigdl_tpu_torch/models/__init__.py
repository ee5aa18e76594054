from .transformer_lm import TransformerLM

__all__ = ["TransformerLM"]
