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
per rank). ``dygraph`` runs the imperative mode: eager layers on a tape,
``to_static`` capture, ``DataParallel``; ``dygraph.guard()`` takes the
card unless given ``CPUPlace()``. The data plane — ``reader``
(``DataLoader``, ``PyReader``, the decorators), ``DataFeeder``,
``dataio`` (the ordered worker pool and ``DevicePrefetcher``),
``dataset`` (``DatasetFactory``, on the native MultiSlot feed) and
``Executor.train_from_dataset`` with ``trainer_desc`` /
``device_worker`` — feeds programs; ``fleet.parameter_server`` trains
against the native parameter server (``distributed/ps.py``).
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
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.dygraph.base import in_dygraph_mode
from paddle_tpu_torch import fleet
from paddle_tpu_torch import io
from paddle_tpu_torch import initializer
from paddle_tpu_torch import optimizer
from paddle_tpu_torch import regularizer
from paddle_tpu_torch import clip
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch import reader
from paddle_tpu_torch.reader import DataLoader, PyReader
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch import dataset
from paddle_tpu_torch.dataset import DatasetFactory
from paddle_tpu_torch import trainer_desc
from paddle_tpu_torch import device_worker
from paddle_tpu_torch.layers.tensor import data_v2 as data
from paddle_tpu_torch.utils.enforce import EnforceError



class FetchHandler:
    """Periodic fetch callback for dataset training (reference:
    python/paddle/fluid/executor.py:406), the JAX package's. Subclass and
    override handler(); handler receives {fetch_name: value} built from
    the train_from_dataset fetch_list (var_dict is accepted for reference
    API parity). ``background=True`` moves delivery onto an
    observability.FetchHandlerMonitor thread so the cadence holds even
    when single steps outlast period_secs."""

    def __init__(self, var_dict=None, period_secs=60, background=False):
        self.var_dict = var_dict or {}
        self.period_secs = period_secs
        self.background = background

    def handler(self, fetch_vars):
        import numpy as _np

        for name, value in fetch_vars.items():
            print(f"{name}: {_np.asarray(value).reshape(-1)[:8]}")


__version__ = "0.1.0"
