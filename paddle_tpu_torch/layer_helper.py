"""LayerHelper: the bridge from layer functions to IR ops.

Same role as the reference's LayerHelper (reference: python/paddle/fluid/
layer_helper.py) — creates parameters (with their init ops in the startup
program), temp output variables, and appends OpDescs to the current block.
Output shapes/dtypes are inferred by running the op's torch lowering on
``meta`` tensors, which carry shape and dtype and no data: one
shape-inference implementation shared with execution, as the JAX package
does with ``jax.eval_shape``. A kernel-backed op gives its shape through
its plain lowering here; no kernel runs at build time.
"""

import torch

from paddle_tpu_torch.core.dtypes import convert_dtype, to_torch_dtype
from paddle_tpu_torch.core.ir import default_main_program, default_startup_program
from paddle_tpu_torch.core.registry import OpRegistry
from paddle_tpu_torch.initializer import ConstantInitializer, XavierInitializer
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.utils import unique_name

# Sentinel concrete size standing in for dynamic (-1) dims during abstract
# evaluation; a large prime so products involving it stay recognizable.
_DYN_SENTINEL = 1031

_META = torch.device("meta")


def infer_op_shapes(op_type, block, inputs, attrs):
    """Run an op's lowering on meta tensors to get its output shapes.
    Returns {slot: [(shape, dtype_str), ...]} or None if not inferable.
    Dynamic (-1) dims run with a sentinel size and map back to -1."""
    if not OpRegistry.has(op_type):
        return None
    op_def = OpRegistry.get(op_type)
    ins = {}
    had_dynamic = False
    for slot, names in inputs.items():
        vals = []
        for n in names:
            v = block._find_var_recursive(n)
            if v is None or v.shape is None:
                return None
            had_dynamic = had_dynamic or any(d < 0 for d in v.shape)
            shape = tuple(_DYN_SENTINEL if d < 0 else d for d in v.shape)
            vals.append(torch.empty(shape, dtype=to_torch_dtype(v.dtype),
                                    device=_META))
        ins[slot] = vals
    if op_def.stateful:
        ins["__rng_key__"] = [(0, 0)]
    if op_def.creates:
        ins["__device__"] = [_META]
    clean_attrs = {k: v for k, v in attrs.items() if k != "op_callstack"}
    try:
        out = op_def.lower(ins, clean_attrs)
    except Exception:  # value-dependent or unsupported: leave shape unset
        return None
    result = {}
    for slot, vals in out.items():
        result[slot] = [
            (
                tuple(
                    -1 if had_dynamic and d > 0 and d % _DYN_SENTINEL == 0 else d
                    for d in t.shape
                ),
                convert_dtype(t.dtype),
            )
            for t in vals
        ]
    return result


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)
        self.main_program = kwargs.get("main_program") or default_main_program()
        self.startup_program = (
            kwargs.get("startup_program") or default_startup_program()
        )

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def create_parameter(
        self, attr, shape, dtype="float32", is_bias=False, default_initializer=None
    ):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")
        if default_initializer is None:
            default_initializer = (
                ConstantInitializer(0.0) if is_bias else XavierInitializer()
            )
        init = attr.initializer or default_initializer
        # init op goes into the startup program
        sblock = self.startup_program.global_block()
        if name not in sblock.vars:
            svar = sblock.create_var(
                name=name, shape=shape, dtype=dtype, persistable=True
            )
            init(svar, sblock)
        # parameter lives in the main program's global block
        gblock = self.main_program.global_block()
        if name in gblock.vars:
            return gblock.vars[name]
        param = gblock.create_parameter(
            shape,
            dtype,
            name=name,
            trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
            regularizer=attr.regularizer,
        )
        return param

    def create_variable_for_type_inference(self, dtype="float32", stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(self.name + ".tmp"),
            dtype=dtype,
            shape=None,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = self.block.append_op(type, inputs, outputs, attrs or {})
        # propagate inferred shapes onto output variables so downstream
        # layers can read .shape at build time
        inferred = infer_op_shapes(type, self.block, op.inputs, op.attrs)
        if inferred:
            for slot, names in op.outputs.items():
                if slot not in inferred:
                    continue
                for (shape, dtype), n in zip(inferred[slot], names):
                    v = self.block.vars.get(n)
                    if v is not None and v.shape is None:
                        v.shape = shape
                        v.dtype = dtype
        return op

    def append_activation(self, out_var):
        act = self.kwargs.get("act")
        if act is None:
            return out_var
        act_out = self.create_variable_for_type_inference(out_var.dtype)
        self.append_op(act, {"X": [out_var.name]}, {"Out": [act_out.name]})
        return act_out

    def append_bias_op(self, out_var, bias, axis=1):
        tmp = self.create_variable_for_type_inference(out_var.dtype)
        self.append_op(
            "elementwise_add",
            {"X": [out_var.name], "Y": [bias.name]},
            {"Out": [tmp.name]},
            {"axis": axis},
        )
        return tmp
