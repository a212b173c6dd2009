"""Hand-written CUDA kernels behind the op registry.

``registry`` holds the mode (``auto``/``off``) and the launch counters,
``build`` compiles ``csrc/*.cu`` with ``nvcc`` at first use,
``attention`` holds the paged/cached decode-attention wrappers and
``flash_attention`` the training attention's forward and backward
wrappers, ``embedding`` the embedding engine's admission scatter and
``sparse_update`` the sparse SGD row update, ``topk`` DGC's blocked
top-k of |x|, ``random`` the threefry bits and fused dropout forward
behind the random ops, each with its plain PyTorch version. Importing this package builds nothing.
"""

from paddle_tpu_torch.kernels import registry  # noqa: F401
from paddle_tpu_torch.kernels.registry import (  # noqa: F401
    KERNELS,
    launches,
    mode,
    reset_launches,
    scoped_mode,
)
