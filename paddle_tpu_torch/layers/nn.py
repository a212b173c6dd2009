"""Neural-net layer functions (reference: python/paddle/fluid/layers/nn.py).

The builders the decode engine's, BERT's, the CTR models', the book
programs' and ResNet's programs use, copied from the JAX package's ``layers/nn.py`` so both packages emit the same op
types, attributes and variable names. Every function appends OpDescs to
the current block via LayerHelper; no computation happens at build time.
"""

import math

from paddle_tpu_torch.initializer import ConstantInitializer, NormalInitializer
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.utils.enforce import enforce

__all__ = [
    "fc",
    "embedding",
    "sharded_embedding",
    "layer_norm",
    "scaled_dot_product_attention",
    "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "sigmoid",
    "scale",
    "mean",
    "reduce_sum",
    "clip",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "elementwise_sub",
    "log_softmax",
    "pow",
    "square",
    "cached_attention",
    "paged_attention",
    "block_gather",
    "block_scatter_write",
    "logits_mask_add",
    "softmax",
    "matmul",
    "elementwise_op",
    "elementwise_add",
    "elementwise_mul",
    "unsqueeze",
    "squeeze",
    "dropout",
    "conv2d",
    "pool2d",
    "batch_norm",
    "cross_entropy",
    "square_error_cost",
    "topk",
    "accuracy",
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


def sharded_embedding(
    input,
    embedding_dim,
    capacity=65536,
    ep=1,
    name=None,
    init_range=0.01,
    lr=0.1,
    seed=0,
    min_bucket=8,
    vocab_size=None,
):
    """Embedding over the two-tier sharded engine (``embedding/``): hot
    rows live in a device slab of ``capacity`` rows (hash-partitioned into
    ``ep`` slot ranges), the cold tail overflows to host RAM, and the step
    gathers the slab ONCE at the batch's deduplicated unique ids.

    The graph sees only cache-sized tensors: ``<name>__slots`` (unique slot
    indices, bucket-padded) and ``<name>__inv`` (occurrence -> unique map),
    both produced per step by ``EmbeddingEngine.prepare_feed``. The slab
    trains with its OWN row-sparse SGD at ``lr`` — the deferred
    ``sharded_embedding_update`` pass strips whatever dense optimizer
    ``minimize`` attached (an Adam step on untouched cached rows would
    drift them, breaking the engine's cache-size invariance)."""
    from paddle_tpu_torch.core.ir import default_main_program
    from paddle_tpu_torch.embedding.table import TableConfig
    from paddle_tpu_torch.layers import tensor as tensor_layers
    from paddle_tpu_torch.param_attr import ParamAttr
    from paddle_tpu_torch.utils import unique_name

    helper = LayerHelper("sharded_embedding", name=name)
    tname = name or unique_name.generate("sharded_emb")
    cfg = TableConfig(
        tname, embedding_dim, capacity, ep=ep, vocab_size=vocab_size,
        init_range=init_range, lr=lr, seed=seed, min_bucket=min_bucket,
    )
    program = default_main_program()
    tables = getattr(program, "_sharded_tables", None)
    if tables is None:
        tables = program._sharded_tables = {}

    slab = helper.create_parameter(
        ParamAttr(name=cfg.slab_name,
                  initializer=ConstantInitializer(0.0)),
        shape=[cfg.capacity, cfg.dim], dtype="float32",
    )
    slots = tensor_layers.data(
        f"{tname}__slots", shape=[-1], dtype="int32",
        append_batch_size=False,
    )
    ids_shape = [d for d in (input.shape or [-1])]
    if len(ids_shape) >= 2 and ids_shape[-1] == 1:
        ids_shape = ids_shape[:-1]
    idx_shape = [(-1 if d in (-1, None) else d) for d in ids_shape]
    inv = tensor_layers.data(
        f"{tname}__inv", shape=idx_shape, dtype="int32",
        append_batch_size=False,
    )
    out = helper.create_variable_for_type_inference("float32")
    out.shape = idx_shape + [cfg.dim]
    out.stop_gradient = False
    helper.append_op(
        "sharded_embedding_lookup",
        {"Table": [slab.name], "Slots": [slots.name], "Inv": [inv.name]},
        {"Out": [out.name]},
        cfg.to_attrs(),
    )
    program._wants_sharded_embedding_update = True
    tables[tname] = {
        "table_name": tname,
        "ids": input.name,
        "slots": slots.name,
        "inv": inv.name,
        "slab": cfg.slab_name,
        "dim": cfg.dim,
        "capacity": cfg.capacity,
        "ep": cfg.ep,
        "vocab_size": vocab_size,
        "init_range": cfg.init_range,
        "lr": cfg.lr,
        "seed": cfg.seed,
        "min_bucket": cfg.min_bucket,
    }
    return out


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
    data_format="NCHW",
):
    """reference: python/paddle/fluid/layers/nn.py conv2d. The filter
    defaults to ``Normal(0, sqrt(2 / fan_in))``."""
    helper = LayerHelper(
        "conv2d", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    dtype = input.dtype
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    channels = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    enforce(channels % groups == 0, "channels must divide groups")
    filter_shape = [num_filters, channels // groups] + list(filter_size)
    fan_in = (channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        helper.param_attr,
        shape=filter_shape,
        dtype=dtype,
        default_initializer=NormalInitializer(0.0, math.sqrt(2.0 / fan_in)),
    )
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv2d",
        {"Input": [input.name], "Filter": [w.name]},
        {"Output": [out.name]},
        {
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
            "data_format": data_format,
        },
    )
    if helper.bias_attr is not False:
        b = helper.create_parameter(
            helper.bias_attr, shape=[num_filters], dtype=dtype, is_bias=True
        )
        out = helper.append_bias_op(out, b, axis=1 if data_format == "NCHW" else 3)
    return helper.append_activation(out)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    exclusive=True,
    adaptive=False,
    name=None,
):
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d",
        {"X": [input.name]},
        {"Out": [out.name]},
        {
            "pooling_type": pool_type,
            "ksize": pool_size,
            "strides": pool_stride,
            "paddings": pool_padding,
            "global_pooling": global_pooling,
            "exclusive": exclusive,
            "adaptive": adaptive,
        },
    )
    return out


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    use_global_stats=False,
):
    """reference: python/paddle/fluid/layers/nn.py batch_norm. Scale
    ``Constant(1)``, bias 0; the moving mean ``Constant(0)`` and variance
    ``Constant(1)`` are persistable, non-trainable parameters that the op
    updates through ``MeanOut``/``VarianceOut`` (the scope write-back)."""
    helper = LayerHelper(
        "batch_norm", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    dtype = input.dtype if input.dtype != "float16" else "float32"
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        helper.param_attr,
        shape=[channels],
        dtype=dtype,
        default_initializer=ConstantInitializer(1.0),
    )
    bias = helper.create_parameter(
        helper.bias_attr, shape=[channels], dtype=dtype, is_bias=True
    )
    mean = helper.create_parameter(
        ParamAttr(
            name=moving_mean_name,
            initializer=ConstantInitializer(0.0),
            trainable=False,
        ),
        shape=[channels],
        dtype=dtype,
    )
    variance = helper.create_parameter(
        ParamAttr(
            name=moving_variance_name,
            initializer=ConstantInitializer(1.0),
            trainable=False,
        ),
        shape=[channels],
        dtype=dtype,
    )
    mean.stop_gradient = True
    variance.stop_gradient = True
    out = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        "batch_norm",
        {
            "X": [input.name],
            "Scale": [scale.name],
            "Bias": [bias.name],
            "Mean": [mean.name],
            "Variance": [variance.name],
        },
        {
            "Y": [out.name],
            "MeanOut": [mean.name],
            "VarianceOut": [variance.name],
            "SavedMean": [saved_mean.name],
            "SavedVariance": [saved_var.name],
        },
        {
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        },
    )
    return helper.append_activation(out)


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper(
        "layer_norm", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    dtype = input.dtype
    in_shape = list(input.shape) if input.shape is not None else None
    enforce(
        in_shape is not None,
        "layer_norm input has no inferred shape; build it from layers "
        "that propagate shape (fluid.data, fc, elementwise ops)",
    )
    if begin_norm_axis < 0:
        begin_norm_axis += len(in_shape)
    enforce(
        0 < begin_norm_axis < len(in_shape),
        f"begin_norm_axis {begin_norm_axis} out of range for input rank "
        f"{len(in_shape)}",
    )
    norm_dims = in_shape[begin_norm_axis:]
    if scale or shift:
        # the scale/bias parameter is sized by the normalized region — a
        # dynamic (-1) dim there has no buildable parameter shape
        enforce(
            all(int(d) > 0 for d in norm_dims),
            f"layer_norm normalizes over dims {norm_dims} "
            f"(begin_norm_axis={begin_norm_axis}) which contain a dynamic "
            "-1 dim, so the Scale/Bias parameter size is unknown at build "
            "time. Normalize over trailing static dims (e.g. "
            "begin_norm_axis=-1 for the feature axis) or pass "
            "scale=False, shift=False",
        )
    norm_shape = [int(math.prod(norm_dims))]
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(
            helper.param_attr,
            shape=norm_shape,
            dtype=dtype,
            default_initializer=ConstantInitializer(1.0),
        )
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(
            helper.bias_attr, shape=norm_shape, dtype=dtype, is_bias=True
        )
        inputs["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        "layer_norm",
        inputs,
        {"Y": [out.name], "Mean": [mean.name], "Variance": [var.name]},
        {"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
    )
    # layer_norm is shape-preserving: guarantee the output shape even when
    # abstract evaluation could not run (dynamic dims), so fc and friends
    # stacked on top can always read .shape at build time
    if out.shape is None:
        out.shape = tuple(in_shape)
    if mean.shape is None:
        mean.shape = tuple(in_shape[:begin_norm_axis])
        var.shape = tuple(in_shape[:begin_norm_axis])
    return helper.append_activation(out)


def scaled_dot_product_attention(q, k, v, bias=None, causal=False,
                                 sm_scale=None, seq_parallel=None,
                                 seq_axis="seq", name=None):
    """Fused attention over [B, H, S, D] tensors; ``bias`` is an optional
    [B, S] additive key bias (padding mask). On a CUDA tensor the op runs
    the hand-written flash-attention kernels (``kernels/flash_attention.py``)
    and its grad their backward kernels; otherwise the plain composite.
    ``seq_parallel`` is recorded for parity with the JAX package; the port
    has no mesh, so the plain single-shard path runs (identical math)."""
    helper = LayerHelper("scaled_dot_product_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if bias is not None:
        inputs["Bias"] = [bias.name]
    attrs = {"causal": causal}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    if seq_parallel:
        attrs["seq_parallel"] = seq_parallel
        attrs["seq_axis"] = seq_axis
    helper.append_op(
        "scaled_dot_product_attention", inputs, {"Out": [out.name]}, attrs
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


def log_softmax(input, axis=-1, name=None):
    return _single_op("log_softmax", input, {"axis": axis}, name=name)


def pow(x, factor=1.0, name=None):
    return _single_op("pow", x, {"factor": factor}, name=name)


def square(x, name=None, **attrs):
    return _single_op("square", x, attrs, name=name)


def elementwise_op(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        op_type, {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]}, {"axis": axis}
    )
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_min", x, y, axis, act, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "scale",
        {"X": [x.name]},
        {"Out": [out.name]},
        {"scale": scale, "bias": bias, "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def mean(x, name=None):
    return _single_op("mean", x, name=name)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    attrs = {
        "dim": dim if dim is not None else [0],
        "keep_dim": keep_dim,
        "reduce_all": dim is None,
    }
    return _single_op("reduce_sum", input, attrs, name=name)


def clip(x, min, max, name=None):
    return _single_op("clip", x, {"min": min, "max": max}, name=name)


def softmax_with_cross_entropy(
    logits,
    label,
    soft_label=False,
    ignore_index=-100,
    return_softmax=False,
    axis=-1,
    name=None,
):
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "softmax_with_cross_entropy",
        {"Logits": [logits.name], "Label": [label.name]},
        {"Softmax": [softmax_out.name], "Loss": [loss.name]},
        {"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100, name=None):
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "cross_entropy",
        {"X": [input.name], "Label": [label.name]},
        {"Y": [out.name]},
        {"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "square_error_cost",
        {"X": [input.name], "Y": [label.name]},
        {"Out": [out.name]},
    )
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op(
        "top_k",
        {"X": [input.name]},
        {"Out": [values.name], "Indices": [indices.name]},
        {"k": k},
    )
    return values, indices


def accuracy(input, label, k=1, name=None):
    """reference: python/paddle/fluid/layers/metric_op.py accuracy."""
    helper = LayerHelper("accuracy", name=name)
    values, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    correct = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    total = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op(
        "accuracy",
        {"Out": [values.name], "Indices": [indices.name], "Label": [label.name]},
        {"Accuracy": [acc.name], "Correct": [correct.name], "Total": [total.name]},
    )
    return acc


def sigmoid(x, name=None, **attrs):
    return _single_op("sigmoid", x, attrs, name=name)


def sigmoid_cross_entropy_with_logits(
    x, label, ignore_index=-100, normalize=False, name=None
):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "sigmoid_cross_entropy_with_logits",
        {"X": [x.name], "Label": [label.name]},
        {"Out": [out.name]},
        {"ignore_index": ignore_index, "normalize": normalize},
    )
    return out


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


def dropout(
    x,
    dropout_prob,
    is_test=False,
    seed=0,
    name=None,
    dropout_implementation="downgrade_in_infer",
):
    """reference: python/paddle/fluid/layers/nn.py dropout. ``Mask`` is a
    saved output (``x.dtype``, no gradient) that the grad op reuses."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        "dropout",
        {"X": [x.name]},
        {"Out": [out.name], "Mask": [mask.name]},
        {
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out
