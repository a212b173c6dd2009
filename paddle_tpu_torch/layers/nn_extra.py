"""Layer functions over the ops of ``ops/nn_extra.py`` and a few of
``ops/tensor.py`` (reference: python/paddle/fluid/layers/nn.py +
loss.py), copied from the JAX package's ``layers/nn_extra.py`` so both
packages emit the same op types, attributes and variable names."""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "selu", "brelu", "soft_relu", "stanh", "sign",
    "argsort", "eye", "diag", "expand_as", "strided_slice", "reverse",
    "scatter_nd_add", "pad2d", "rank", "size", "crop_tensor",
    "log_loss", "label_smooth",
    "adaptive_pool2d",
]


def _simple(op, ins, attrs, dtype="float32", outs=("Out",), name=None):
    helper = LayerHelper(op, name=name)
    out_vars = [helper.create_variable_for_type_inference(dtype) for _ in outs]
    helper.append_op(
        op, ins, {slot: [v.name] for slot, v in zip(outs, out_vars)}, attrs
    )
    return out_vars[0] if len(out_vars) == 1 else tuple(out_vars)


def _x_op(op, x, attrs=None, name=None, out_slot="Out"):
    return _simple(op, {"X": [x.name]}, attrs or {}, x.dtype,
                   (out_slot,), name)


# -- activations ---------------------------------------------------------
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _x_op("selu", x, {"scale": scale, "alpha": alpha}, name)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _x_op("brelu", x, {"t_min": t_min, "t_max": t_max}, name)


def soft_relu(x, threshold=40.0, name=None):
    return _x_op("soft_relu", x, {"threshold": threshold}, name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _x_op("stanh", x, {"scale_a": scale_a, "scale_b": scale_b}, name)


def sign(x, name=None):
    return _x_op("sign", x, {}, name)


# -- tensor utilities ----------------------------------------------------
def argsort(x, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ids = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        "argsort", {"X": [x.name]},
        {"Out": [out.name], "Indices": [ids.name]},
        {"axis": axis, "descending": descending},
    )
    return out, ids


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    attrs = {"num_rows": num_rows, "dtype": dtype}
    if num_columns is not None:
        attrs["num_columns"] = num_columns
    return _simple("eye", {}, attrs, dtype, name=name)


def diag(diagonal, name=None):
    return _simple("diag", {"Diagonal": [diagonal.name]}, {},
                   diagonal.dtype, name=name)


def expand_as(x, target_tensor, name=None):
    return _simple(
        "expand_as",
        {"X": [x.name], "target_tensor": [target_tensor.name]}, {},
        x.dtype, name=name,
    )


def strided_slice(input, axes, starts, ends, strides, name=None):
    return _simple(
        "strided_slice", {"Input": [input.name]},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends),
         "strides": list(strides)},
        input.dtype, name=name,
    )


def reverse(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return _x_op("reverse", x, {"axis": list(axis)}, name)


def scatter_nd_add(ref, index, updates, name=None):
    return _simple(
        "scatter_nd_add",
        {"X": [ref.name], "Index": [index.name], "Updates": [updates.name]},
        {}, ref.dtype, name=name,
    )


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _x_op(
        "pad2d", input,
        {"paddings": list(paddings), "mode": mode, "pad_value": pad_value},
        name,
    )


def rank(input, name=None):
    return _simple("rank", {"Input": [input.name]}, {}, "int32", name=name)


def size(input, name=None):
    return _simple("size", {"Input": [input.name]}, {}, "int64", name=name)


def crop_tensor(x, shape, offsets, name=None):
    return _x_op(
        "crop_tensor", x,
        {"shape": list(shape), "offsets": list(offsets)}, name,
    )


# -- losses --------------------------------------------------------------
def log_loss(input, label, epsilon=1e-4, name=None):
    return _simple(
        "log_loss",
        {"Predicted": [input.name], "Labels": [label.name]},
        {"epsilon": epsilon}, input.dtype, ("Loss",), name,
    )


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    ins = {"X": [label.name]}
    if prior_dist is not None:
        ins["PriorDist"] = [prior_dist.name]
    return _simple("label_smooth", ins, {"epsilon": epsilon},
                   label.dtype, name=name)


# -- vision --------------------------------------------------------------
def adaptive_pool2d(input, pool_size, pool_type="avg", name=None):
    ps = [pool_size] * 2 if isinstance(pool_size, int) else list(pool_size)
    return _x_op(
        "adaptive_pool2d", input,
        {"pooled_height": ps[0], "pooled_width": ps[1],
         "pooling_type": pool_type},
        name,
    )
