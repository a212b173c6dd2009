"""Continuous-batching paged decode: the port of the JAX package's
``serving/decode`` (decode, chunked prefill, speculative decoding and
committed-stream sampling)."""

from paddle_tpu_torch.serving.decode.engine import (
    GenerationEngine,
    GenerationRequest,
)
from paddle_tpu_torch.serving.decode.generate import SamplingParams
from paddle_tpu_torch.serving.decode.model import DecodeModel, build_decoder_model
from paddle_tpu_torch.serving.decode.pool import (
    BlockPool,
    PrefixCache,
    SlotPool,
    block_hashes,
    prompt_key,
)

__all__ = [
    "BlockPool",
    "DecodeModel",
    "GenerationEngine",
    "GenerationRequest",
    "PrefixCache",
    "SamplingParams",
    "SlotPool",
    "block_hashes",
    "build_decoder_model",
    "prompt_key",
]
