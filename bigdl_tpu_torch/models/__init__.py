from .transformer_lm import TransformerLM, lm_loss_chunked

__all__ = ["TransformerLM", "lm_loss_chunked"]
