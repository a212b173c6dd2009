"""Optimizer update op lowerings, with the semantics of the JAX package's
``ops/optimizers.py``: the arithmetic runs in float32 (moments and other
accumulators stay float32) and the updated parameter is cast back to its
own dtype. The update ops return new tensors for ``ParamOut`` and the
accumulators (whose names equal the inputs'); the executor writes them
back to the scope. A scalar divides as a 0-d float32 tensor: torch
multiplies by the reciprocal of a Python-scalar divisor on CUDA (and
``scalar / tensor`` is ``reciprocal(tensor) * scalar``), where the JAX
op divides. ``lamb``'s and ``lars_momentum``'s trust ratios take the JAX
``where`` branch at a zero norm. ``dpsgd`` draws its noise as the JAX
op's ``jax.random.normal`` at the op's key, its bits through K8's
``random_bits`` on the card (``ops/tensor.py`` ``draw``). ``sgd_sparse`` updates its parameter in place (the
counterpart of the JAX package's donated buffer): an optimizer op runs
after every op that reads the parameter, and rewriting a whole ``[V, D]``
table to touch a few thousand rows would cost far more than the update."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.kernels import sparse_update, topk
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.ops.common import (
    first, jnp_clip, maybe, rng_key, segment_sum)
from paddle_tpu_torch.ops.tensor import draw
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.utils.enforce import EnforceError
from paddle_tpu_torch.utils.flags import flags


def _f32(x):
    return x.to(torch.float32)


@register_op("sgd")
def _sgd(ins, attrs):
    p, g, lr = first(ins, "Param"), first(ins, "Grad"), first(ins, "LearningRate")
    out = _f32(p) - _f32(lr) * _f32(g)
    return {"ParamOut": [out.to(p.dtype)]}


@register_op("sgd_sparse", nondiff_inputs=("Ids",), reports_late=True)
def _sgd_sparse(ins, attrs):
    """SelectedRows-analog row update (reference: paddle/fluid/operators/
    optimizers/sgd_op.h sparse branch), emitted by the
    ``sparse_weight_update`` pass in place of lookup_table_v2_grad + sgd:
    the looked-up rows' cotangent scatter-subtracts straight into the
    touched parameter rows, in place.

    Flag off: one accumulating ``index_put_`` (duplicate ids combine inside
    it, deterministically on every device). Flag on
    (``FLAGS_pallas_sparse_update``): the duplicates are merged first
    (``torch.unique`` — a sync with the card, the op's only one — and a
    segment-sum of the scaled rows), then the sparse-row kernel K6 adds
    each merged row once, taking ``torch.unique``'s int64 ids as they are
    (``kernels/sparse_update.py``; kernel mode ``off`` takes its plain
    version). ``torch.unique`` returns exactly the unique ids, so no fill
    rows reach the kernel. K6 finds an id outside the table on the card,
    so there the executor raises it at the end of the run
    (``reports_late``)."""
    p = first(ins, "Param")
    ids = first(ins, "Ids").reshape(-1)
    rows = first(ins, "RowGrad")
    lr = _f32(first(ins, "LearningRate")).reshape(())
    d = p.shape[-1]
    rows2 = rows.reshape(-1, d).to(p.dtype)
    pi = attrs.get("padding_idx", -1)
    if pi is not None and pi >= 0:
        # the forward zeroed padding rows, so their grads must not land
        rows2 = torch.where((ids == pi)[:, None], 0.0, rows2)
    scaled = -(lr.to(p.dtype)) * rows2
    if flags.pallas_sparse_update:
        uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
        merged = segment_sum(scaled, inv, uniq.shape[0])
        update = (sparse_update.sparse_row_update_plain
                  if kernel_registry.mode() == "off"
                  else sparse_update.sparse_row_update)
        return {"ParamOut": [update(p, uniq, merged)]}
    return {"ParamOut": [p.index_put_((ids.to(torch.int64),), scaled,
                                      accumulate=True)]}


@register_op("momentum")
def _momentum(ins, attrs):
    p, g = _f32(first(ins, "Param")), _f32(first(ins, "Grad"))
    v, lr = _f32(first(ins, "Velocity")), _f32(first(ins, "LearningRate"))
    mu = attrs.get("mu", 0.9)
    rd = attrs.get("regularization_coeff", 0.0)
    if rd and attrs.get("regularization_method", "") == "l2_decay":
        g = g + rd * p
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - lr * (g + mu * v_out)
    else:
        p_out = p - lr * v_out
    return {
        "ParamOut": [p_out.to(first(ins, "Param").dtype)],
        "VelocityOut": [v_out],
    }


@register_op("adam")
def _adam(ins, attrs):
    p = _f32(first(ins, "Param"))
    g = _f32(first(ins, "Grad"))
    m1, m2 = _f32(first(ins, "Moment1")), _f32(first(ins, "Moment2"))
    b1p, b2p = _f32(first(ins, "Beta1Pow")), _f32(first(ins, "Beta2Pow"))
    lr = _f32(first(ins, "LearningRate"))
    b1 = float(maybe(ins, "Beta1Tensor", attrs.get("beta1", 0.9)))
    b2 = float(maybe(ins, "Beta2Tensor", attrs.get("beta2", 0.999)))
    eps = attrs.get("epsilon", 1e-8)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {
        "ParamOut": [p_out.to(first(ins, "Param").dtype)],
        "Moment1Out": [m1n],
        "Moment2Out": [m2n],
        "Beta1PowOut": [b1p * b1],
        "Beta2PowOut": [b2p * b2],
    }


def _scalar(v, like):
    """``v`` as a 0-d float32 tensor beside ``like`` (a true divisor)."""
    return torch.full((), prng.f32(v), dtype=torch.float32, device=like.device)


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


def _param_out(p_out, ins):
    return p_out.to(first(ins, "Param").dtype)


@register_op("adamw")
def _adamw(ins, attrs):
    """Decoupled weight decay on top of adam."""
    coeff = attrs.get("coeff", 0.01)
    p = _f32(first(ins, "Param"))
    lr = _f32(first(ins, "LearningRate"))
    outs = _adam(ins, attrs)
    decayed = _f32(outs["ParamOut"][0]) - lr * coeff * p
    outs["ParamOut"] = [_param_out(decayed, ins)]
    return outs


@register_op("adagrad")
def _adagrad(ins, attrs):
    p, g = _f32(first(ins, "Param")), _f32(first(ins, "Grad"))
    moment, lr = _f32(first(ins, "Moment")), _f32(first(ins, "LearningRate"))
    eps = attrs.get("epsilon", 1e-6)
    m_out = moment + torch.square(g)
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [_param_out(p_out, ins)], "MomentOut": [m_out]}


@register_op("rmsprop")
def _rmsprop(ins, attrs):
    p, g = _f32(first(ins, "Param")), _f32(first(ins, "Grad"))
    ms, lr = _f32(first(ins, "MeanSquare")), _f32(first(ins, "LearningRate"))
    mom = _f32(first(ins, "Moment"))
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    mg_out = None
    if attrs.get("centered", False):
        mg_out = rho * _f32(first(ins, "MeanGrad")) + (1 - rho) * g
        denom = torch.sqrt(ms_out - torch.square(mg_out) + eps)
    else:
        denom = torch.sqrt(ms_out + eps)
    mom_out = momentum * mom + lr * g / denom
    outs = {
        "ParamOut": [_param_out(p - mom_out, ins)],
        "MomentOut": [mom_out],
        "MeanSquareOut": [ms_out],
    }
    if mg_out is not None:
        outs["MeanGradOut"] = [mg_out]
    return outs


@register_op("adamax")
def _adamax(ins, attrs):
    p, g = _f32(first(ins, "Param")), _f32(first(ins, "Grad"))
    m, inf_norm = _f32(first(ins, "Moment")), _f32(first(ins, "InfNorm"))
    b1p, lr = _f32(first(ins, "Beta1Pow")), _f32(first(ins, "LearningRate"))
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf_norm, torch.abs(g))
    p_out = p - (lr / (1 - b1p)) * m_out / (inf_out + eps)
    return {"ParamOut": [_param_out(p_out, ins)], "MomentOut": [m_out],
            "InfNormOut": [inf_out]}


@register_op("adadelta")
def _adadelta(ins, attrs):
    p, g = _f32(first(ins, "Param")), _f32(first(ins, "Grad"))
    avg_sq_grad = _f32(first(ins, "AvgSquaredGrad"))
    avg_sq_upd = _f32(first(ins, "AvgSquaredUpdate"))
    rho, eps = attrs.get("rho", 0.95), attrs.get("epsilon", 1e-6)
    asg_out = rho * avg_sq_grad + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_upd + eps) / (asg_out + eps)) * g
    asu_out = rho * avg_sq_upd + (1 - rho) * torch.square(update)
    return {"ParamOut": [_param_out(p + update, ins)],
            "AvgSquaredGradOut": [asg_out],
            "AvgSquaredUpdateOut": [asu_out]}


@register_op("decayed_adagrad")
def _decayed_adagrad(ins, attrs):
    p, g = _f32(first(ins, "Param")), _f32(first(ins, "Grad"))
    moment, lr = _f32(first(ins, "Moment")), _f32(first(ins, "LearningRate"))
    decay, eps = attrs.get("decay", 0.95), attrs.get("epsilon", 1e-6)
    m_out = decay * moment + (1 - decay) * torch.square(g)
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [_param_out(p_out, ins)], "MomentOut": [m_out]}


@register_op("ftrl")
def _ftrl(ins, attrs):
    p, g = _f32(first(ins, "Param")), _f32(first(ins, "Grad"))
    sq = _f32(first(ins, "SquaredAccumulator"))
    lin = _f32(first(ins, "LinearAccumulator"))
    lr = _f32(first(ins, "LearningRate"))
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    new_lin = lin + g - sigma * p
    x = jnp_clip(new_lin, -l1, l1) - new_lin
    y = torch.pow(new_sq, -power) / lr + 2 * l2
    return {"ParamOut": [_param_out(x / y, ins)],
            "SquaredAccumOut": [new_sq], "LinearAccumOut": [new_lin]}


@register_op("lamb")
def _lamb(ins, attrs):
    """reference: paddle/fluid/operators/optimizers/lamb_op.h — layerwise
    adaptive moments, the large-batch BERT optimizer."""
    p = _f32(first(ins, "Param"))
    g = _f32(first(ins, "Grad"))
    m1, m2 = _f32(first(ins, "Moment1")), _f32(first(ins, "Moment2"))
    b1p, b2p = _f32(first(ins, "Beta1Pow")), _f32(first(ins, "Beta2Pow"))
    lr = _f32(first(ins, "LearningRate"))
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    m1_hat = m1n / (1 - b1p)
    m2_hat = m2n / (1 - b2p)
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    p_norm, r_norm = _norm(p), _norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        _scalar(1.0, p))
    p_out = p - lr * trust * r
    return {
        "ParamOut": [_param_out(p_out, ins)],
        "Moment1Out": [m1n],
        "Moment2Out": [m2n],
        "Beta1PowOut": [b1p * b1],
        "Beta2PowOut": [b2p * b2],
    }


@register_op("lars_momentum")
def _lars_momentum(ins, attrs):
    p, g = _f32(first(ins, "Param")), _f32(first(ins, "Grad"))
    v, lr = _f32(first(ins, "Velocity")), _f32(first(ins, "LearningRate"))
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + wd * p_norm + eps),
        lr,
    )
    v_out = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": [_param_out(p - v_out, ins)], "VelocityOut": [v_out]}


@register_op("dpsgd", stateful=True)
def _dpsgd(ins, attrs):
    """Differentially-private SGD (reference: paddle/fluid/operators/
    optimizers/dpsgd_op.cc): clip the grad to ``clip`` in norm, add
    Gaussian noise (``jax.random.normal`` at the op's key)."""
    p, g = _f32(first(ins, "Param")), _f32(first(ins, "Grad"))
    lr = _f32(first(ins, "LearningRate"))
    clip = attrs.get("clip", 10.0)
    batch_size = attrs.get("batch_size", 16.0)
    sigma = attrs.get("sigma", 1.0)
    g_norm = _norm(g)
    g = torch.where(g_norm > clip, g * (_scalar(clip, g) / g_norm), g)
    z = draw({"__rng_key__": [rng_key(ins)]}, {}, tuple(g.shape),
             prng.normal, g.device)
    noise = sigma * clip * z
    p_out = p - lr * (g + noise / _scalar(batch_size, g))
    return {"ParamOut": [_param_out(p_out, ins)]}


@register_op("ema_update")
def _ema_update(ins, attrs):
    """Shadow-parameter EMA step (reference: python/paddle/fluid/
    optimizer.py:3166 ExponentialMovingAverage — its in-graph ema ops)."""
    p, s = first(ins, "Param"), first(ins, "Shadow")
    decay = attrs.get("decay", 0.999)
    return {"ShadowOut": [decay * s + (1.0 - decay) * p.to(s.dtype)]}


@register_op("model_average_update")
def _model_average_update(ins, attrs):
    """Windowed running parameter sum (reference: python/paddle/fluid/
    optimizer.py:2862 ModelAverage accumulators). The window is
    clamp(rate * total_updates, min_window, max_window); once ``count``
    reaches it the sum decays geometrically. Count stores
    (window_count, total_updates)."""
    p = first(ins, "Param")
    s, c = first(ins, "Sum"), first(ins, "Count")
    rate = attrs.get("rate", 0.15)
    min_w = attrs.get("min_window", 10000.0)
    max_w = attrs.get("max_window", 10000.0)
    flat = c.reshape(-1)
    cnt = flat[0]
    total = flat[1] if c.numel() > 1 else cnt
    window = jnp_clip(rate * (total + 1.0), min_w, max_w)
    at_cap = cnt >= window
    new_sum = torch.where(at_cap, s * (window - 1.0) / window, s) \
        + p.to(s.dtype)
    new_cnt = torch.minimum(cnt + 1.0, window)
    return {"SumOut": [new_sum],
            "CountOut": [torch.stack([new_cnt, total + 1.0])]}


def dgc_ratio(step, begin, ramp, sparsity):
    """The warm-up ramp through the sparsity list at ``step`` (a 0-d
    float32 tensor), in float32 exactly as the JAX lowering computes it;
    0 (dense, plain momentum) before ``rampup_begin_step``."""
    sp = torch.tensor(sparsity, dtype=torch.float32, device=step.device)
    n = sp.shape[0]
    idx = torch.clamp(((step - begin) * n / ramp).to(torch.int32), 0, n - 1)
    return torch.where(step < begin, torch.zeros((), device=step.device),
                       sp[idx.to(torch.int64)])


def dgc_k(size, sparsity):
    """The static top-k bound of a ``size``-element parameter: the k of the
    final (smallest-ratio, largest-k) sparsity, as in the JAX lowering."""
    return max(1, int(round(size * (1.0 - float(min(sparsity))))))


def dgc_statically_sparse(begin, sparsity):
    """Whether the schedule never takes the dense branch: rampup begins at
    step 0 or before and every sparsity is positive (the production DGC
    configuration). Then no dense all-reduce ever goes on the wire."""
    return float(begin) <= 0.0 and min(float(x) for x in sparsity) > 0.0


def _quantile_linear(a, q):
    """``jnp.quantile(a, q)`` (method "linear") of a 1-D float32 ``a`` at a
    0-d float32 ``q``, by a sort, in float32 as JAX computes it.
    ``torch.quantile`` refuses inputs over 2^24 elements; a word embedding
    has more."""
    n = torch.tensor(float(a.shape[0]), dtype=torch.float32, device=a.device)
    srt = torch.sort(a).values
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    zero = torch.zeros((), device=a.device)
    low = torch.clamp(low, zero, n - 1).to(torch.int64)
    high = torch.clamp(high, zero, n - 1).to(torch.int64)
    out = srt[low] * low_w + srt[high] * high_w
    # any NaN makes the quantile NaN, as in jnp.quantile
    return torch.where(torch.isnan(a).any(), torch.full_like(out, torch.nan),
                       out)


def _dgc_topk_idx(v_acc, k):
    """Indices of the top ``k`` of ``|v_acc|``: descending value, ties by
    lower index (``lax.top_k``'s order), through K7 under
    ``FLAGS_pallas_dgc_topk``."""
    if flags.pallas_dgc_topk:
        fn = (topk.blocked_topk_abs_plain if kernel_registry.mode() == "off"
              else topk.blocked_topk_abs)
        return fn(v_acc, k)[1]
    return topk.topk_abs_exact(v_acc, k)[1]


@register_op("check_finite_and_unscale", nondiff_inputs=("Scale",))
def _check_finite_and_unscale(ins, attrs):
    """reference: paddle/fluid/operators/amp/check_finite_and_unscale_op.cc
    (the JAX package's op): every gradient times 1/Scale, and whether any
    is non-finite, as a device tensor (no sync with the host)."""
    xs = ins.get("X", [])
    scale = _f32(first(ins, "Scale")).reshape(())
    inv = 1.0 / scale
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    outs = []
    for x in xs:
        found = torch.logical_or(found, torch.logical_not(torch.isfinite(x).all()))
        outs.append((_f32(x) * inv).to(x.dtype))
    return {"Out": outs, "FoundInfinite": [found.reshape(1)]}


@register_op("update_loss_scaling", nondiff_inputs=(
    "FoundInfinite", "PrevLossScaling", "InGoodSteps", "InBadSteps"))
def _update_loss_scaling(ins, attrs):
    """reference: paddle/fluid/operators/amp/update_loss_scaling_op.cc, as
    the JAX package computes it. On overflow the gradients become zeros
    (the optimizer ops still run on them, so Adam's moments still decay,
    as in the JAX package), and after ``decr_every_n_nan_or_inf``
    overflows in a row the scale shrinks; after ``incr_every_n_steps``
    clean steps it grows. Scale and counters stay on the device: no
    branch on their values."""
    xs = ins.get("X", [])
    found = first(ins, "FoundInfinite").reshape(()).to(torch.bool)
    prev = first(ins, "PrevLossScaling")
    scale = _f32(prev).reshape(())
    good = first(ins, "InGoodSteps").reshape(()).to(torch.int32)
    bad = first(ins, "InBadSteps").reshape(()).to(torch.int32)
    incr_every = attrs.get("incr_every_n_steps", 1000)
    decr_every = attrs.get("decr_every_n_nan_or_inf", 2)
    incr_ratio = attrs.get("incr_ratio", 2.0)
    decr_ratio = attrs.get("decr_ratio", 0.5)
    zero = torch.zeros_like(bad)
    new_bad = torch.where(found, bad + 1, zero)
    new_good = torch.where(found, zero, good + 1)
    should_decr = new_bad >= decr_every
    should_incr = new_good >= incr_every
    new_scale = torch.where(should_decr, scale * decr_ratio, scale)
    new_scale = torch.where(should_incr, scale * incr_ratio, new_scale)
    new_scale = torch.clamp_min(new_scale, 1e-8)
    new_bad = torch.where(should_decr, zero, new_bad)
    new_good = torch.where(should_incr, zero, new_good)
    outs = [torch.where(found, torch.zeros_like(x), x) for x in xs]
    return {
        "Out": outs,
        "LossScaling": [new_scale.reshape(1).to(prev.dtype)],
        "OutGoodSteps": [new_good.reshape(1)],
        "OutBadSteps": [new_bad.reshape(1)],
    }


@register_op("dgc_momentum")
def _dgc_momentum(ins, attrs):
    """DGC update (reference: paddle/fluid/operators/dgc_op.cc semantics):
    u = mu*u + g; v += u; select |v| above the sparsity quantile; apply the
    selected update; clear u, v where selected (error feedback keeps the
    rest). Before ``rampup_begin_step`` it is plain momentum.

    Two forms, as in the JAX lowering:

    * dense fused (no DGC axis): the selection is ``|v| >=`` the
      ``ratio`` quantile of ``|v|``, on the rank's own gradient;
    * sparse exchange (``CompiledProgram`` data parallel: the DGC context
      names an axis over two or more ranks): U/V arrive ``[1, ...]`` (this
      rank's slice), Grad is this rank's local-batch gradient. Each rank
      keeps the top ``k_max`` of ``|v + contrib|``, masks the tail past the
      ramp's ``k_dyn``, all-gathers the (index, value) pairs (2*k*n values
      on the wire instead of the dense gradient) and scatter-adds them in
      rank order, divided by n — the same update on every rank.

    The phase (dense warm-up or sparse) is the JAX ``lax.cond``'s; eager
    code decides it on the host, from the step the DGC context carries
    (``CompiledProgram`` reads the counter once per run), else from one
    read of ``CurrentStep``. A statically sparse schedule never reads it
    and never runs the dense branch's all-reduce."""
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    u, v = first(ins, "U"), first(ins, "V")
    lr = _f32(first(ins, "LearningRate")).reshape(())
    step = first(ins, "CurrentStep").reshape(())
    mu = attrs.get("mu", 0.9)
    begin = attrs.get("rampup_begin_step", 0.0)
    ramp = max(attrs.get("rampup_step", 1.0), 1.0)
    sparsity = attrs.get("sparsity", [0.999])
    axis = penv.current_dgc_axis()

    if axis is None and u.dim() == p.dim() + 1:
        raise EnforceError(
            "dgc accumulators carry per-rank state (leading rank axis) "
            "from a sparse-exchange CompiledProgram run; keep running the "
            "compiled program, or reset the accumulators, before using the "
            "plain Executor"
        )
    if axis is not None:
        u, v = u[0], v[0]

    u_new = mu * u + g
    contrib = g + mu * u_new if attrs.get("use_nesterov", False) else u_new
    statically_sparse = (axis is not None
                         and dgc_statically_sparse(begin, sparsity))
    host_step = penv.current_dgc_step()
    if host_step is None and not statically_sparse:
        host_step = float(step)                      # one sync with the card
    if host_step is not None:
        ratio = dgc_ratio(torch.tensor(host_step, dtype=torch.float32),
                          begin, ramp, sparsity)
        is_dense = bool(ratio <= 0.0)
        ratio = ratio.to(p.device)
    else:
        ratio = dgc_ratio(step.to(torch.float32), begin, ramp, sparsity)
        is_dense = False

    if axis is not None:
        if is_dense and not statically_sparse:
            update = penv.pmean(contrib, axis)
            return {
                "ParamOut": [p - lr.to(p.dtype) * update],
                "UOut": [u_new[None]],
                "VOut": [v[None]],
            }
        size = p.numel()
        k_max = dgc_k(size, sparsity)
        v_acc = (v + contrib).reshape(-1)
        top_idx = _dgc_topk_idx(v_acc, k_max)
        k_dyn = torch.round(size * (1.0 - ratio)).to(torch.int32)
        keep = (torch.arange(k_max, device=p.device)
                < torch.clamp_min(k_dyn, 1)).to(v_acc.dtype)
        vals = v_acc[top_idx] * keep
        all_idx, all_vals = penv.all_gather_pairs(top_idx, vals, axis)
        update = torch.zeros(size, dtype=v_acc.dtype, device=p.device)
        # one accumulating index_put_: rank order, the same bits on every
        # run and every rank
        update = (update.index_put_((all_idx.reshape(-1).to(torch.int64),),
                                    all_vals.reshape(-1), accumulate=True)
                  / axis.size).reshape(p.shape)
        sent = torch.zeros(size, dtype=torch.bool, device=p.device)
        sent[top_idx.to(torch.int64)] = keep > 0
        sent = sent.reshape(p.shape)
        zero = torch.zeros((), dtype=u_new.dtype, device=p.device)
        return {
            "ParamOut": [p - lr.to(p.dtype) * update],
            "UOut": [torch.where(sent, zero, u_new)[None]],
            "VOut": [torch.where(sent, zero, v_acc.reshape(p.shape))[None]],
        }

    if is_dense:
        return {"ParamOut": [p - lr.to(p.dtype) * contrib], "UOut": [u_new],
                "VOut": [v]}
    v_acc = v + contrib
    absv = torch.abs(v_acc)
    thr = _quantile_linear(absv.reshape(-1).to(torch.float32), ratio)
    mask = absv >= thr.to(absv.dtype)
    zero = torch.zeros((), dtype=v_acc.dtype, device=p.device)
    return {
        "ParamOut": [p - lr.to(p.dtype) * torch.where(mask, v_acc, zero)],
        "UOut": [torch.where(mask, zero, u_new)],
        "VOut": [torch.where(mask, zero, v_acc)],
    }
