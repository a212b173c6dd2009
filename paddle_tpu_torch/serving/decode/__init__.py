"""Continuous-batching paged decode: the port of the JAX package's
``serving/decode`` (decode, chunked prefill, speculative decoding,
committed-stream sampling, beam search and grammar-constrained decode;
under overload, parking to the host-RAM KV tier, the brownout ladder,
the circuit breaker and weighted-fair tenants)."""

from paddle_tpu_torch.serving.brownout import (
    SEVERITY_NAMES,
    BrownoutController,
)

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
from paddle_tpu_torch.serving.decode.metrics import DecodeMetrics
from paddle_tpu_torch.serving.decode.model import DecodeModel, build_decoder_model
from paddle_tpu_torch.serving.decode.pool import (
    BlockPool,
    PrefixCache,
    SlotPool,
    block_hashes,
    prompt_key,
)
from paddle_tpu_torch.serving.decode.tier import HostKVTier

__all__ = [
    "BeamParams",
    "BlockPool",
    "BrownoutController",
    "CompiledGrammar",
    "DecodeMetrics",
    "DecodeModel",
    "GenerationEngine",
    "GenerationRequest",
    "GrammarConstraint",
    "HostKVTier",
    "PrefixCache",
    "SEVERITY_NAMES",
    "SamplingParams",
    "SlotPool",
    "block_hashes",
    "build_decoder_model",
    "prompt_key",
]
