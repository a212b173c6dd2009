"""Op lowerings: importing this package registers them."""

from paddle_tpu_torch.ops import (  # noqa: F401
    control_flow, fused, math, misc_extra, nn, optimizers, sharded_embedding,
    tensor)
