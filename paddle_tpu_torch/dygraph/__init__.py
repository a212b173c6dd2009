"""Imperative (dygraph) mode: eager execution over the port's op
lowerings, with the JAX package's ``dygraph`` surface.

reference: python/paddle/fluid/dygraph/ and paddle/fluid/imperative/.
See base.py for the tracer and the tape."""

from paddle_tpu_torch.dygraph.base import (
    enable_dygraph,
    disable_dygraph,
    guard,
    in_dygraph_mode,
    no_grad,
    to_variable,
    trace_op,
    _dygraph_tracer,
)
from paddle_tpu_torch.dygraph.varbase import ParamBase, VarBase
from paddle_tpu_torch.dygraph.layers import Layer
from paddle_tpu_torch.dygraph.container import LayerList, ParameterList, Sequential
from paddle_tpu_torch.dygraph import nn
from paddle_tpu_torch.dygraph.nn import (
    BatchNorm,
    Conv2D,
    Conv2DTranspose,
    Dropout,
    Embedding,
    GroupNorm,
    GRUUnit,
    InstanceNorm,
    LayerNorm,
    Linear,
    Pool2D,
    PRelu,
)
from paddle_tpu_torch.dygraph.checkpoint import load_dygraph, save_dygraph
from paddle_tpu_torch.dygraph.parallel import DataParallel, ParallelEnv, prepare_context
from paddle_tpu_torch.dygraph.jit import TracedLayer, declarative, to_static
