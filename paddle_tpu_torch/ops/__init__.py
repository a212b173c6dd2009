"""Op lowerings: importing this package registers them."""

from paddle_tpu_torch.ops import math, nn, tensor  # noqa: F401
