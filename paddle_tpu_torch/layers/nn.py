"""Neural-net layer functions (reference: python/paddle/fluid/layers/nn.py).

The builders the decode engine's programs use, copied from the JAX
package's ``layers/nn.py`` so both packages emit the same op types,
attributes and variable names. Every function appends OpDescs to the
current block via LayerHelper; no computation happens at build time.
"""

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.utils.enforce import enforce

__all__ = [
    "fc",
    "embedding",
    "cached_attention",
    "paged_attention",
    "block_gather",
    "block_scatter_write",
    "logits_mask_add",
    "softmax",
    "matmul",
    "elementwise_op",
    "elementwise_add",
    "unsqueeze",
    "squeeze",
]


def _single_op(op_type, x, attrs=None, out_dtype=None, name=None, extra_inputs=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(out_dtype or x.dtype)
    inputs = {"X": [x.name]}
    if extra_inputs:
        inputs.update(extra_inputs)
    helper.append_op(op_type, inputs, {"Out": [out.name]}, attrs or {})
    return out


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    """reference: python/paddle/fluid/layers/nn.py:205."""
    helper = LayerHelper(
        "fc", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    dtype = input.dtype
    input_shape = input.shape
    enforce(
        input_shape is not None,
        f"fc input '{input.name}' has no inferred shape, so the weight "
        "size is unknown at build time. Stack fc on layers that propagate "
        "shape, or set the var's .shape explicitly",
    )
    feature_dims = list(input_shape[num_flatten_dims:])
    enforce(
        all(int(d) > 0 for d in feature_dims),
        f"fc input '{input.name}' flattened feature dims {feature_dims} "
        "contain a dynamic -1 dim; fc needs static feature dims (choose "
        "num_flatten_dims so only leading dims are dynamic)",
    )
    in_features = 1
    for d in feature_dims:
        in_features *= d
    w = helper.create_parameter(
        helper.param_attr, shape=[in_features, size], dtype=dtype
    )
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "mul",
        {"X": [input.name], "Y": [w.name]},
        {"Out": [out.name]},
        {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    if helper.bias_attr is not False:
        b = helper.create_parameter(
            helper.bias_attr, shape=[size], dtype=dtype, is_bias=True
        )
        out = helper.append_bias_op(out, b, axis=num_flatten_dims)
    return helper.append_activation(out)


def embedding(
    input,
    size,
    is_sparse=False,
    is_distributed=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
    name=None,
):
    """reference: python/paddle/fluid/layers/nn.py embedding. A dense row
    gather; ``is_sparse`` is accepted for API parity."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(helper.param_attr, shape=list(size), dtype=dtype)
    w.is_distributed = is_distributed
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lookup_table_v2",
        {"W": [w.name], "Ids": [input.name]},
        {"Out": [out.name]},
        {"padding_idx": -1 if padding_idx is None else padding_idx},
    )
    return out


def block_gather(arena, rows, seqs, length, name=None):
    """Gather a per-sequence KV view out of a flat paged arena:
    ``arena`` ``[R, H]`` + flat row indices ``rows`` ``[seqs * length]``
    -> ``[seqs, length, H]``. Position ``p`` of sequence ``s`` reads arena
    row ``rows[s * length + p]``; rows at masked positions may point
    anywhere — the additive ``-1e9`` attention bias makes their
    contribution exactly 0.0."""
    from paddle_tpu_torch.layers.tensor import gather, reshape

    flat = gather(arena, rows, name=name)              # [seqs*length, H]
    return reshape(flat, [int(seqs), int(length), -1])


def block_scatter_write(arena, rows, new_rows, name=None):
    """Write ``new_rows`` ``[N, H]`` into flat paged arena ``arena``
    ``[R, H]`` at row indices ``rows`` ``[N]`` (callers persist with
    ``assign``; the executor then writes into the arena in place). An
    index >= R means "this row writes NOWHERE" (``mode="drop"``) — how
    retired/inactive batch slots stay untouched without changing the
    program's shapes."""
    from paddle_tpu_torch.layers.tensor import scatter

    return scatter(arena, rows, new_rows, overwrite=True, mode="drop",
                   name=name)


def logits_mask_add(logits, mask, name=None):
    """Additive logits mask for constrained decode: ``logits + mask``
    where ``mask`` is host-built, 0.0 at allowed tokens and ``-1e9`` at
    banned ones. ``x + 0.0 == x`` in IEEE float32, so an all-zeros mask
    leaves every logit untouched."""
    return elementwise_add(logits, mask, name=name)


def cached_attention(q, k_cache, v_cache, attn_bias, sm_scale=1.0,
                     fused=False, name=None):
    """Single-position attention of ``q`` ``[S, H]`` over a slotted KV
    cache ``[S, L, H]``. ``attn_bias`` is an additive ``[S, 1, L]`` mask:
    0.0 at positions ``<= cursor``, -1e9 beyond. Returns ``[S, H]``.

    ``fused=True`` emits ONE ``cached_attention`` op, which the kernel
    registry serves with the hand-written CUDA kernel on a CUDA tensor
    (``kernels/attention.py`` ``decode_attention``); the default emits
    the matmul/softmax composite, as the JAX package does."""
    if fused:
        helper = LayerHelper("cached_attention", name=name)
        out = helper.create_variable_for_type_inference(q.dtype)
        helper.append_op(
            "cached_attention",
            {"Q": [q.name], "KCache": [k_cache.name],
             "VCache": [v_cache.name], "Bias": [attn_bias.name]},
            {"Out": [out.name]},
            {"sm_scale": float(sm_scale)},
        )
        return out
    q3 = unsqueeze(q, [1], name=name)                    # [S, 1, H]
    scores = matmul(q3, k_cache, transpose_y=True, alpha=float(sm_scale))
    att = softmax(elementwise_add(scores, attn_bias), axis=-1)
    return squeeze(matmul(att, v_cache), [1])            # [S, H]


def paged_attention(q, k_arena, v_arena, rows, attn_bias, seqs, length,
                    sm_scale=1.0, name=None):
    """Fused paged attention: ``q`` ``[S, H]`` attends over rows of the
    flat ``[R, H]`` block arenas addressed by the ``[S * L]`` row feed —
    ``block_gather(k) ; block_gather(v) ; cached_attention`` as ONE op,
    served on a CUDA tensor by the hand-written paged-attention kernel,
    which gathers rows inside the kernel instead of materialising the
    ``[S, L, H]`` views."""
    helper = LayerHelper("paged_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op(
        "paged_attention",
        {"Q": [q.name], "KArena": [k_arena.name], "VArena": [v_arena.name],
         "Rows": [rows.name], "Bias": [attn_bias.name]},
        {"Out": [out.name]},
        {"sm_scale": float(sm_scale), "seqs": int(seqs),
         "length": int(length)},
    )
    return out


def softmax(input, axis=-1, name=None):
    return _single_op("softmax", input, {"axis": axis}, name=name)


def elementwise_op(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        op_type, {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]}, {"axis": axis}
    )
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_add", x, y, axis, act, name)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "matmul",
        {"X": [x.name], "Y": [y.name]},
        {"Out": [out.name]},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": alpha},
    )
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(
        "unsqueeze2",
        {"X": [input.name]},
        {"Out": [out.name], "XShape": [xshape.name]},
        {"axes": axes},
    )
    return out


def squeeze(input, axes=None, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(
        "squeeze2",
        {"X": [input.name]},
        {"Out": [out.name], "XShape": [xshape.name]},
        {"axes": axes or []},
    )
    return out
