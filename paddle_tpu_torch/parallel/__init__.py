"""Data parallelism over ``torch.distributed`` (reference:
paddle/fluid/platform/collective_helper.h; the JAX package's
``parallel/``): the 1-D data mesh, its collectives and the ``c_*`` rings
(``env``), the dense data-parallel plan (``data_parallel``) and the DGC
sparse exchange (``dgc``)."""

from paddle_tpu_torch.parallel.env import (  # noqa: F401
    Axis,
    Mesh,
    ParallelEnv,
    collective_context,
    current_dgc_axis,
    current_mesh_axis,
    dgc_axis_context,
    make_mesh,
)
