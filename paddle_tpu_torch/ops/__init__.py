"""Op lowerings: importing this package registers them."""

from paddle_tpu_torch.ops import (  # noqa: F401
    control_flow, extras, fused, math, misc_extra, nn, nn_extra, optimizers,
    pipeline, recompute, sharded_embedding, tensor)
