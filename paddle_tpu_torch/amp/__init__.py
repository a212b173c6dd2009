"""bf16 / float16 mixed precision as a program rewrite (``decorate``)."""

from paddle_tpu_torch.amp.decorator import (  # noqa: F401
    AutoMixedPrecisionLists,
    OptimizerWithMixedPrecision,
    decorate,
    rewrite_program_amp,
)
