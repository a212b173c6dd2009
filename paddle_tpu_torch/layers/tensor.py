"""Tensor creation/manipulation layer functions
(reference: python/paddle/fluid/layers/tensor.py). The builders the
decode engine's programs use, copied from the JAX package's
``layers/tensor.py`` so both packages emit the same ops and names."""

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.core.ir import default_main_program
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "data",
    "fill_constant",
    "assign",
    "reshape",
    "gather",
    "scatter",
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
