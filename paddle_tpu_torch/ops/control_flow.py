"""Control-flow helper op lowerings, with the semantics of the JAX
package's ``ops/control_flow.py``. The port carries ``increment`` (the
learning-rate schedules' step counter); ``while`` / ``conditional_block``
and the rest come later."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import first


@register_op("increment")
def _increment(ins, attrs):
    x = first(ins, "X")
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                     device=x.device)]}
