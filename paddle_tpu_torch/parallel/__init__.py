"""Data parallelism over ``torch.distributed`` (reference:
paddle/fluid/platform/collective_helper.h; the JAX package's
``parallel/``): the 1-D data mesh and its collectives (``env``) and the
DGC sparse exchange (``dgc``)."""

from paddle_tpu_torch.parallel.env import (  # noqa: F401
    Axis,
    Mesh,
    ParallelEnv,
    current_dgc_axis,
    dgc_axis_context,
    make_mesh,
)
