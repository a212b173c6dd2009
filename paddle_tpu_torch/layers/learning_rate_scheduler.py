"""Learning-rate schedules as program ops over a persistable step counter
(reference: python/paddle/fluid/layers/learning_rate_scheduler.py —
schedules are ops reading @LR_DECAY_COUNTER@), copied from the JAX
package's module so both packages emit the same ops: the step counter
and the eight schedules."""

import math

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import tensor

__all__ = [
    "noam_decay",
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "cosine_decay",
    "linear_lr_warmup",
]

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    from paddle_tpu_torch.core.ir import default_main_program

    helper = LayerHelper("global_step_counter")
    already = _COUNTER_NAME in default_main_program().global_block().vars
    counter = tensor.create_global_var(
        shape=[1],
        value=float(begin),
        dtype="float32",
        persistable=True,
        name=_COUNTER_NAME,
    )
    # composed schedules share one counter: only the first creator appends
    # the per-step increment
    if not already:
        helper.append_op(
            "increment",
            {"X": [counter.name]},
            {"Out": [counter.name]},
            # optimize role: the counter ticks once per step
            {"step": 1.0, "op_role": 2},
        )
    return counter


def _floor(x):
    helper = LayerHelper("floor")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("floor", {"X": [x.name]}, {"Out": [out.name]})
    return out


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (reference: python/paddle/fluid/layers/learning_rate_scheduler.py:63)."""
    from paddle_tpu_torch import layers

    step = _decay_step_counter(begin=1)
    a = layers.pow(step, -0.5)
    b = layers.scale(step, scale=warmup_steps ** -1.5)
    return layers.scale(layers.elementwise_min(a, b), scale=d_model ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    from paddle_tpu_torch import layers

    step = _decay_step_counter()
    div = layers.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = _floor(div)
    return layers.scale(
        layers.elementwise_pow(
            tensor.fill_constant([1], "float32", decay_rate), div
        ),
        scale=float(learning_rate),
    )


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    from paddle_tpu_torch import layers

    step = _decay_step_counter()
    div = layers.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = _floor(div)
    return layers.scale(
        layers.exp(layers.scale(div, scale=-decay_rate)),
        scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    from paddle_tpu_torch import layers

    step = _decay_step_counter()
    div = layers.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = _floor(div)
    denom = layers.scale(div, scale=decay_rate, bias=1.0)
    lr = tensor.fill_constant([1], "float32", float(learning_rate))
    return layers.elementwise_div(lr, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from paddle_tpu_torch import layers

    step = _decay_step_counter()
    capped = layers.clip(step, 0.0, float(decay_steps))
    frac = layers.scale(capped, scale=1.0 / decay_steps)
    one_minus = layers.scale(frac, scale=-1.0, bias=1.0)
    poly = layers.pow(one_minus, factor=power)
    return layers.scale(
        poly, scale=float(learning_rate) - end_learning_rate,
        bias=end_learning_rate
    )


def piecewise_decay(boundaries, values):
    step = _decay_step_counter()
    lr = tensor.fill_constant([1], "float32", values[-1])
    # nested wheres, built right to left
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        boundary = tensor.fill_constant([1], "float32", float(b))
        is_before = tensor.less_than(step, boundary)
        lr = tensor.where(is_before, tensor.fill_constant([1], "float32", v),
                          lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    from paddle_tpu_torch import layers

    step = _decay_step_counter()
    epoch = _floor(layers.scale(step, scale=1.0 / step_each_epoch))
    cosv = layers.cos(layers.scale(epoch, scale=math.pi / epochs))
    return layers.scale(cosv, scale=0.5 * learning_rate,
                        bias=0.5 * learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from paddle_tpu_torch import layers

    step = _decay_step_counter()
    if not hasattr(learning_rate, "name"):
        learning_rate = tensor.fill_constant([1], "float32", float(learning_rate))
    frac = layers.clip(layers.scale(step, scale=1.0 / warmup_steps), 0.0, 1.0)
    warm = layers.scale(frac, scale=end_lr - start_lr, bias=start_lr)
    boundary = tensor.fill_constant([1], "float32", float(warmup_steps))
    in_warmup = tensor.less_than(step, boundary)
    return tensor.where(in_warmup, warm, learning_rate)
