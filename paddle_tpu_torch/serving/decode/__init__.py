"""Continuous-batching paged decode: the port of the JAX package's
``serving/decode`` (decode, chunked prefill, speculative decoding,
committed-stream sampling, beam search and grammar-constrained
decode)."""

from paddle_tpu_torch.serving.decode.engine import (
    GenerationEngine,
    GenerationRequest,
)
from paddle_tpu_torch.serving.decode.generate import (
    BeamParams,
    CompiledGrammar,
    GrammarConstraint,
    SamplingParams,
)
from paddle_tpu_torch.serving.decode.model import DecodeModel, build_decoder_model
from paddle_tpu_torch.serving.decode.pool import (
    BlockPool,
    PrefixCache,
    SlotPool,
    block_hashes,
    prompt_key,
)

__all__ = [
    "BeamParams",
    "BlockPool",
    "CompiledGrammar",
    "DecodeModel",
    "GenerationEngine",
    "GenerationRequest",
    "GrammarConstraint",
    "PrefixCache",
    "SamplingParams",
    "SlotPool",
    "block_hashes",
    "build_decoder_model",
    "prompt_key",
]
