"""Incubating APIs: automatic checkpoints with CRC manifests, walk-back
and format-2 shards (``checkpoint``)."""

from paddle_tpu_torch.incubate import checkpoint  # noqa: F401
