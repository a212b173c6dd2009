"""Tensor creation/manipulation layer functions
(reference: python/paddle/fluid/layers/tensor.py). The builders the
decode engine's and BERT's programs use, copied from the JAX package's
``layers/tensor.py`` so both packages emit the same ops and names."""

import builtins as _builtins

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.core.ir import default_main_program, default_startup_program
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.utils import unique_name

# this module defines a `range` LAYER below, which shadows the builtin for
# any module-level function that runs after import — keep the real one
_builtin_range = _builtins.range

__all__ = [
    "data",
    "fill_constant",
    "assign",
    "cast",
    "reshape",
    "transpose",
    "slice",
    "gather",
    "batched_gather",
    "scatter",
    "where",
    "create_global_var",
    "sums",
    "concat",
    "equal",
    "not_equal",
    "less_than",
    "less_equal",
    "greater_than",
    "greater_equal",
    "logical_and",
    "logical_or",
    "logical_not",
    "increment",
    "uniform_random",
    "gaussian_random",
    # M12a
    "fill_constant_batch_size_like",
    "zeros",
    "ones",
    "zeros_like",
    "ones_like",
    "split",
    "flatten",
    "stack",
    "unstack",
    "expand",
    "gather_nd",
    "cond_select",
    "shape",
    "range",
    "linspace",
    "create_tensor",
    "cumsum",
    "isfinite",
    "pad",
]


def data(name, shape, dtype="float32", append_batch_size=True, lod_level=0):
    """Declare a feed slot (reference: python/paddle/fluid/layers/io.py
    data — append_batch_size prepends the dynamic batch dim)."""
    block = default_main_program().global_block()
    if append_batch_size:
        shape = [-1] + list(shape)
    shape = [-1 if d is None else d for d in shape]
    return block.create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        is_data=True,
        stop_gradient=True,
        lod_level=lod_level,
    )


def data_v2(name, shape, dtype="float32", lod_level=0):
    """The reference's top-level `fluid.data` (python/paddle/fluid/data.py):
    shape taken verbatim, None/-1 marks dynamic dims, NO batch prepend."""
    return data(name, shape, dtype, append_batch_size=False, lod_level=lod_level)


def fill_constant(shape, dtype, value, name=None, out=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(
        "fill_constant",
        {},
        {"Out": [out.name]},
        {"shape": list(shape), "dtype": convert_dtype(dtype), "value": value},
    )
    out.stop_gradient = True
    return out


def assign(input, output=None, name=None):
    helper = LayerHelper("assign", name=name)
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", {"X": [input.name]}, {"Out": [output.name]})
    return output


def cast(x, dtype, name=None):
    helper = LayerHelper("cast", name=name)
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "cast", {"X": [x.name]}, {"Out": [out.name]}, {"out_dtype": dtype}
    )
    return out


def reshape(x, shape, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        "reshape2",
        {"X": [x.name]},
        {"Out": [out.name], "XShape": [xshape.name]},
        {"shape": list(shape)},
    )
    return out


def sums(input, out=None, name=None):
    """Elementwise sum of a list of tensors (reference: python/paddle/fluid/
    layers/tensor.py sums -> sum op)."""
    helper = LayerHelper("sum", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(
        "sum", {"X": [v.name for v in input]}, {"Out": [out.name]}, {}
    )
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(
        "concat", {"X": [v.name for v in input]}, {"Out": [out.name]}, {"axis": axis}
    )
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        "transpose2",
        {"X": [x.name]},
        {"Out": [out.name], "XShape": [xshape.name]},
        {"axis": list(perm)},
    )
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "slice",
        {"Input": [input.name]},
        {"Out": [out.name]},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def batched_gather(x, index, name=None):
    """X [B, S, ...] + Index [B, P] -> [B, P, ...] (rows per batch)."""
    helper = LayerHelper("batched_gather", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "batched_gather",
        {"X": [x.name], "Index": [index.name]},
        {"Out": [out.name]},
        {},
    )
    return out


def gather(input, index, axis=0, name=None):
    helper = LayerHelper("gather", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "gather",
        {"X": [input.name], "Index": [index.name]},
        {"Out": [out.name]},
        {"axis": axis},
    )
    return out


def scatter(input, index, updates, overwrite=True, mode=None, name=None):
    """Row scatter. ``mode="drop"`` skips out-of-range indices instead
    of clamping — the paged KV arena's "write nowhere" encoding."""
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"overwrite": overwrite}
    if mode is not None:
        attrs["mode"] = mode
    helper.append_op(
        "scatter",
        {"X": [input.name], "Ids": [index.name], "Updates": [updates.name]},
        {"Out": [out.name]},
        attrs,
    )
    return out


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "where",
        {"Condition": [condition.name], "X": [x.name], "Y": [y.name]},
        {"Out": [out.name]},
    )
    return out


def create_global_var(
    shape, value, dtype, persistable=False, force_cpu=False, name=None
):
    """reference: python/paddle/fluid/layers/tensor.py create_global_var —
    value lives in the startup program, var in the main program."""
    name = name or unique_name.generate("global_var")
    sblock = default_startup_program().global_block()
    sblock.create_var(name=name, shape=shape, dtype=dtype, persistable=persistable)
    sblock.append_op(
        "fill_constant",
        {},
        {"Out": [name]},
        {"shape": list(shape), "dtype": convert_dtype(dtype), "value": value},
    )
    mblock = default_main_program().global_block()
    var = mblock.create_var(
        name=name, shape=shape, dtype=dtype, persistable=persistable
    )
    var.stop_gradient = True
    return var


def _make_compare(op_type):
    def fn(x, y, cond=None, name=None):
        # `cond` names an existing output var — the reference uses this to
        # rewrite the loop condition inside While blocks
        helper = LayerHelper(op_type, name=name)
        out = cond if cond is not None else helper.create_variable_for_type_inference(
            "bool", stop_gradient=True
        )
        helper.append_op(
            op_type, {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]}
        )
        return out

    fn.__name__ = op_type
    return fn


equal = _make_compare("equal")
not_equal = _make_compare("not_equal")
less_than = _make_compare("less_than")
less_equal = _make_compare("less_equal")
greater_than = _make_compare("greater_than")
greater_equal = _make_compare("greater_equal")
logical_and = _make_compare("logical_and")
logical_or = _make_compare("logical_or")


def logical_not(x, name=None):
    helper = LayerHelper("logical_not", name=name)
    out = helper.create_variable_for_type_inference("bool", stop_gradient=True)
    helper.append_op("logical_not", {"X": [x.name]}, {"Out": [out.name]})
    return out


def increment(x, value=1.0, in_place=True, name=None):
    helper = LayerHelper("increment", name=name)
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "increment", {"X": [x.name]}, {"Out": [out.name]}, {"step": value}
    )
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    helper = LayerHelper("uniform_random", name=name)
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(
        "uniform_random",
        {},
        {"Out": [out.name]},
        {"shape": list(shape), "dtype": convert_dtype(dtype), "min": min, "max": max, "seed": seed},
    )
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32", name=None):
    helper = LayerHelper("gaussian_random", name=name)
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(
        "gaussian_random",
        {},
        {"Out": [out.name]},
        {"shape": list(shape), "dtype": convert_dtype(dtype), "mean": mean, "std": std, "seed": seed},
    )
    return out


# -- M12a: the common layer surface, copied from the JAX package's
# ``layers/tensor.py`` ---------------------------------------------------------


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0, name=name)


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0, name=name)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  name=None):
    """reference: python/paddle/fluid/layers/tensor.py
    fill_constant_batch_size_like — `shape[output_dim_idx]` is replaced by
    `input.shape[input_dim_idx]` at run time."""
    helper = LayerHelper("fill_constant_batch_size_like", name=name)
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "fill_constant_batch_size_like",
        {"Input": [input.name]},
        {"Out": [out.name]},
        {
            "shape": list(shape),
            "dtype": dtype,
            "value": value,
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    return out


def zeros_like(x, name=None):
    helper = LayerHelper("zeros_like", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", {"X": [x.name]}, {"Out": [out.name]})
    return out


def ones_like(x, name=None):
    helper = LayerHelper("ones_like", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "fill_constant_batch_size_like",
        {"Input": [x.name]},
        {"Out": [out.name]},
        {"shape": list(x.shape), "dtype": x.dtype, "value": 1.0},
    )
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        n_out = num
    else:
        num = 0
        sections = list(num_or_sections)
        n_out = len(sections)
    outs = [
        helper.create_variable_for_type_inference(input.dtype)
        for _ in _builtin_range(n_out)
    ]
    helper.append_op(
        "split",
        {"X": [input.name]},
        {"Out": [o.name for o in outs]},
        {"num": num, "sections": sections, "axis": dim},
    )
    return outs


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        "flatten2",
        {"X": [x.name]},
        {"Out": [out.name], "XShape": [xshape.name]},
        {"axis": axis},
    )
    return out


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(
        "stack", {"X": [v.name for v in x]}, {"Y": [out.name]}, {"axis": axis}
    )
    return out


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack", name=name)
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in _builtin_range(num)]
    helper.append_op(
        "unstack",
        {"X": [x.name]},
        {"Y": [o.name for o in outs]},
        {"axis": axis, "num": num},
    )
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "expand",
        {"X": [x.name]},
        {"Out": [out.name]},
        {"expand_times": list(expand_times)},
    )
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "gather_nd",
        {"X": [input.name], "Index": [index.name]},
        {"Out": [out.name]},
    )
    return out


cond_select = where


def shape(input, name=None):
    helper = LayerHelper("shape", name=name)
    out = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op("shape", {"Input": [input.name]}, {"Out": [out.name]})
    return out


def range(start, end, step, dtype="float32", name=None):
    helper = LayerHelper("range", name=name)
    vals = []
    for v in (start, end, step):
        if not hasattr(v, "name"):
            v = fill_constant([1], dtype, float(v))
        vals.append(v)
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(
        "range",
        {"Start": [vals[0].name], "End": [vals[1].name], "Step": [vals[2].name]},
        {"Out": [out.name]},
    )
    return out


def linspace(start, stop, num, dtype="float32", name=None):
    helper = LayerHelper("linspace", name=name)
    vals = []
    for v, d in ((start, dtype), (stop, dtype), (num, "int32")):
        if not hasattr(v, "name"):
            v = fill_constant([1], d, float(v))
        vals.append(v)
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(
        "linspace",
        {"Start": [vals[0].name], "Stop": [vals[1].name], "Num": [vals[2].name]},
        {"Out": [out.name]},
    )
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.block.create_var(
        name=name or helper.name, dtype=dtype, persistable=persistable, shape=None
    )


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "cumsum",
        {"X": [x.name]},
        {"Out": [out.name]},
        {"axis": axis, "exclusive": exclusive, "reverse": reverse},
    )
    return out


def isfinite(x, name=None):
    helper = LayerHelper("isfinite", name=name)
    out = helper.create_variable_for_type_inference("bool", stop_gradient=True)
    helper.append_op("isfinite", {"X": [x.name]}, {"Out": [out.name]})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "pad",
        {"X": [x.name]},
        {"Out": [out.name]},
        {"paddings": list(paddings), "pad_value": pad_value},
    )
    return out
