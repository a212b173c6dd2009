"""VarBase: the eager tensor, with the surface of the JAX package's
``dygraph/varbase.py`` (reference: paddle/fluid/imperative/layer.h:61
VarBase; python surface python/paddle/fluid/dygraph/
varbase_patch_methods.py). The payload is a torch tensor on the guard's
device; the grad is ``grad_value``, set by the tape walk in
``base.run_backward``."""

import numpy as np
import torch

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.utils import unique_name
from paddle_tpu_torch.utils.enforce import EnforceError, enforce


class VarBase:
    def __init__(self, value, name=None, stop_gradient=False, persistable=False):
        self.value = value
        self.name = name or unique_name.generate("generated_tensor")
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self.grad_value = None
        self.static_var = None  # set when this is a capture-mode proxy

    @classmethod
    def from_static(cls, static_var, stop_gradient=False):
        """Capture-mode proxy bound to an existing static Variable (no
        eager value): ops tracing through it reference `static_var` by
        name."""
        vb = cls.__new__(cls)
        vb.value = None
        vb.name = static_var.name
        vb.stop_gradient = stop_gradient
        vb.persistable = False
        vb.grad_value = None
        vb.static_var = static_var
        return vb

    # -- autograd ------------------------------------------------------
    def backward(self, retain_graph=False):
        from paddle_tpu_torch.dygraph.base import run_backward

        run_backward(self, retain_graph=retain_graph)

    def _accumulate_grad(self, g):
        # the JAX package's rule: the sum over this walk's uses, replacing
        # what an earlier backward left
        self.grad_value = g

    def gradient(self):
        from paddle_tpu_torch.dygraph.base import to_numpy

        return None if self.grad_value is None else to_numpy(self.grad_value)

    @property
    def grad(self):
        return self.grad_value

    def clear_gradient(self):
        self.grad_value = None

    # -- data access ---------------------------------------------------
    def numpy(self):
        from paddle_tpu_torch.dygraph.base import to_numpy

        enforce(self.value is not None, f"{self.name} has no value (capture proxy)")
        return to_numpy(self.value)

    def detach(self):
        return VarBase(self.value, name=self.name + ".detach", stop_gradient=True)

    def item(self):
        return self.numpy().item()

    @property
    def shape(self):
        if self.value is not None:
            return list(self.value.shape)
        return list(self.static_var.shape) if self.static_var is not None else None

    @property
    def dtype(self):
        if self.value is not None:
            return convert_dtype(self.value.dtype)
        return self.static_var.dtype if self.static_var is not None else None

    def astype(self, dtype):
        from paddle_tpu_torch.dygraph.base import trace_op

        return trace_op("cast", {"X": [self]}, {"out_dtype": str(dtype)})["Out"][0]

    def numel(self):
        return int(np.prod(self.shape)) if self.shape else 1

    def set_value(self, value):
        """New contents of the same shape, in this tensor's dtype and on
        its device (a tensor stays on the card; numpy is uploaded)."""
        if isinstance(value, VarBase):
            value = value.value
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        enforce(
            tuple(value.shape) == tuple(self.shape),
            f"set_value shape mismatch: {tuple(value.shape)} vs {self.shape}",
        )
        self.value = value.detach().to(device=self.value.device,
                                       dtype=self.value.dtype)

    def __len__(self):
        return self.shape[0] if self.shape else 0

    # -- control-flow capture guards -----------------------------------
    # A Python `if`/`while` on a tensor calls __bool__. Eagerly that is
    # fine (the value exists; reading it is a host sync); under
    # dygraph-to-static capture the value is symbolic, and Python would
    # otherwise take the default object truthiness (always True) and
    # SILENTLY bake one branch into the traced program: raise instead
    # (``declarative`` converts such branches, ast_transform.py).
    def _concrete(self, what):
        if self.value is None:
            raise EnforceError(
                f"cannot convert symbolic tensor '{self.name}' to {what} "
                "during dygraph-to-static capture: a Python branch/loop on "
                "a traced value would silently bake one path into the "
                "program. Rewrite the data-dependent control flow with "
                "fluid.layers.cond / fluid.layers.while_loop (or a "
                "vectorized select like fluid.layers.where), or run the "
                "layer eagerly instead of tracing it"
            )
        return self.numpy()

    def _scalar(self, what):
        """The single element of a size-1 tensor; multi-element tensors
        keep numpy's error semantics (ambiguous truth / no conversion)."""
        arr = self._concrete(what)
        if arr.ndim and arr.size == 1:
            return arr.reshape(())[()]
        return arr

    def __bool__(self):
        return bool(self._scalar("bool"))

    def __float__(self):
        return float(self._scalar("float"))

    def __int__(self):
        return int(self._scalar("int"))

    def __index__(self):
        return int(self._scalar("index"))

    def __repr__(self):
        tag = "ParamBase" if getattr(self, "trainable", None) is not None else "VarBase"
        return f"{tag}(name={self.name}, shape={self.shape}, dtype={self.dtype})"

    # -- math sugar (reference: math_op_patch applied to VarBase) ------
    def _binary(self, other, op_type, reverse=False):
        from paddle_tpu_torch.dygraph.base import to_variable, trace_op

        if not isinstance(other, VarBase):
            other = to_variable(
                # self.dtype works for capture proxies too (value is None)
                np.full((1,), other, dtype=np.dtype(self.dtype))
            )
        x, y = (other, self) if reverse else (self, other)
        return trace_op(op_type, {"X": [x], "Y": [y]}, {"axis": -1})["Out"][0]

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", reverse=True)

    def __matmul__(self, o):
        from paddle_tpu_torch.dygraph.base import trace_op

        return trace_op("matmul", {"X": [self], "Y": [o]}, {})["Out"][0]

    # comparisons return TENSORS; a Python `if` on the result goes
    # through __bool__, which is guarded against capture proxies above
    def __gt__(self, o):
        return self._binary(o, "greater_than")

    def __ge__(self, o):
        return self._binary(o, "greater_equal")

    def __lt__(self, o):
        return self._binary(o, "less_than")

    def __le__(self, o):
        return self._binary(o, "less_equal")

    def __neg__(self):
        from paddle_tpu_torch.dygraph.base import trace_op

        return trace_op("scale", {"X": [self]}, {"scale": -1.0})["Out"][0]

    def __iter__(self):
        """Row iteration (`for row in x`). Requires a static leading dim;
        validated here so iter(x) fails at the call site."""
        shape = self.shape
        enforce(
            shape is not None and len(shape) > 0,
            f"cannot iterate '{self.name}': 0-d tensors are not iterable",
        )
        enforce(
            shape[0] is not None and shape[0] >= 0,
            f"cannot iterate '{self.name}': leading dimension is not "
            "statically known",
        )
        return (self[i] for i in range(shape[0]))

    def __getitem__(self, idx):
        from paddle_tpu_torch.core.ir import parse_getitem_index
        from paddle_tpu_torch.dygraph.base import trace_op

        axes, starts, ends, squeeze_axes = parse_getitem_index(idx)
        if not axes:
            return self
        out = trace_op(
            "slice",
            {"Input": [self]},
            {"axes": axes, "starts": starts, "ends": ends},
        )["Out"][0]
        if squeeze_axes:
            out = trace_op("squeeze2", {"X": [out]}, {"axes": squeeze_axes})["Out"][0]
        return out


class ParamBase(VarBase):
    """Eager parameter (reference: VarBase with persistable=True +
    python/paddle/fluid/framework.py ParamBase semantics)."""

    def __init__(self, value, name=None, trainable=True, **kwargs):
        super().__init__(value, name=name, persistable=True)
        self.trainable = trainable
        self.stop_gradient = not trainable
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.is_distributed = False
