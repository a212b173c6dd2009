"""Tensor creation/manipulation layer functions
(reference: python/paddle/fluid/layers/tensor.py). The builders the
decode engine's and BERT's programs use, copied from the JAX package's
``layers/tensor.py`` so both packages emit the same ops and names."""

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.core.ir import default_main_program, default_startup_program
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.utils import unique_name

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
    "not_equal",
    "less_than",
    "uniform_random",
    "gaussian_random",
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


not_equal = _make_compare("not_equal")
less_than = _make_compare("less_than")


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
