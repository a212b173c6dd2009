"""Learning-rate schedules as program ops over a persistable step counter
(reference: python/paddle/fluid/layers/learning_rate_scheduler.py —
schedules are ops reading @LR_DECAY_COUNTER@), copied from the JAX
package's module so both packages emit the same ops. The port carries
the step counter, ``noam_decay`` and ``linear_lr_warmup``."""

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import tensor

__all__ = ["noam_decay", "linear_lr_warmup"]

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


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (reference: python/paddle/fluid/layers/learning_rate_scheduler.py:63)."""
    from paddle_tpu_torch import layers

    step = _decay_step_counter(begin=1)
    a = layers.pow(step, -0.5)
    b = layers.scale(step, scale=warmup_steps ** -1.5)
    return layers.scale(layers.elementwise_min(a, b), scale=d_model ** -0.5)


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
