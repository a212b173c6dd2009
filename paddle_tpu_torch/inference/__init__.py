"""Inference: the analysis passes and the predictor, the port's copy of
the JAX package's ``inference/``. An exported model
(``io.save_inference_model``) is loaded with its weights on the card,
rewritten by the analysis passes (``passes.py``: fc and conv-bn folding,
and the unfused attention core onto the flash kernel K1) and served
through prepared input-shape buckets.
"""

from paddle_tpu_torch.inference.predictor import (
    Config,
    PrecisionType,
    Predictor,
    Tensor,
    create_predictor,
)

__all__ = [
    "Config",
    "PrecisionType",
    "Predictor",
    "Tensor",
    "create_predictor",
]
