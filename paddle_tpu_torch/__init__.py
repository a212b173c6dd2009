"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The same Fluid-style surface as the JAX package — Program IR, layer
builders, an Executor over a Scope, op lowerings — with torch tensors
underneath and hand-written CUDA kernels (``kernels/``) where the JAX
package has Pallas kernels. It imports nothing of ``jax`` or
``paddle_tpu``; module names follow the JAX package's so each
counterpart is easy to find.

Entry points (``Executor``, ``CompiledProgram``,
``serving.GenerationEngine``) run on the first CUDA card unless given
``place=CPUPlace()``, and raise when there is no card. ``io`` saves and
loads parameters, persistables and inference models, and
``incubate.checkpoint`` checkpoints and resumes training, in the JAX
package's files: either package reads what the other wrote. ``fleet``
trains data-parallel across ranks, one process each (the collective
mode; ``parallel/data_parallel.py`` runs the JAX package's GSPMD step
per rank).
"""

from paddle_tpu_torch.core import (
    CPUPlace,
    CUDAPlace,
    Program,
    Scope,
    default_main_program,
    default_startup_program,
    global_scope,
    name_scope,
    program_guard,
    scope_guard,
)
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.compiler import (
    BuildStrategy,
    CompiledProgram,
    ExecutionStrategy,
)
import paddle_tpu_torch.ops  # noqa: F401  (registers the op library)
from paddle_tpu_torch import layers
from paddle_tpu_torch import amp
from paddle_tpu_torch import fleet
from paddle_tpu_torch import io
from paddle_tpu_torch import initializer
from paddle_tpu_torch import optimizer
from paddle_tpu_torch import regularizer
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.layers.tensor import data_v2 as data
from paddle_tpu_torch.utils.enforce import EnforceError

__version__ = "0.1.0"
