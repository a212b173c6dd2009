"""Serving: request futures, the admission queue, and the continuous-
batching decode engine."""

from paddle_tpu_torch.serving.decode import (  # noqa: F401
    DecodeModel,
    GenerationEngine,
    build_decoder_model,
)
from paddle_tpu_torch.serving.queue import RequestQueue  # noqa: F401
from paddle_tpu_torch.serving.request import (  # noqa: F401
    DeadlineExceededError,
    Priority,
    RejectedError,
    ReplicaLostError,
    RequestError,
    Response,
    ServingError,
)
