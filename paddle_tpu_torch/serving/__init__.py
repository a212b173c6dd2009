"""Serving: request futures, the admission queue, the continuous-
batching decode engine, and the batching ServingEngine over inference
predictor replicas with its bucket lattice."""

from paddle_tpu_torch.serving.batcher import (  # noqa: F401
    BatchPlan,
    BucketLattice,
    DynamicBatcher,
)
from paddle_tpu_torch.serving.decode import (  # noqa: F401
    DecodeModel,
    GenerationEngine,
    build_decoder_model,
)
from paddle_tpu_torch.serving.engine import ServingEngine  # noqa: F401
from paddle_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from paddle_tpu_torch.serving.queue import RequestQueue  # noqa: F401
from paddle_tpu_torch.serving.request import (  # noqa: F401
    DeadlineExceededError,
    Priority,
    RejectedError,
    ReplicaLostError,
    Request,
    RequestError,
    Response,
    ServingError,
)
