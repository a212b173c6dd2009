"""The random ``*_batch_size_like`` ops, with the semantics of the JAX
package's ``ops/misc_extra.py``: a declared shape whose
``output_dim_idx`` dimension is taken from ``Input``'s ``input_dim_idx``
one, filled with ``jax.random``'s values from the op's key (the bits from
K8 on the card, as the random ops of ``ops/tensor.py`` draw them)."""

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import first
from paddle_tpu_torch.ops.tensor import draw, mean_std


def _batch_shape(ins, attrs):
    shape = [int(d) for d in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = int(
        first(ins, "Input").shape[attrs.get("input_dim_idx", 0)])
    return tuple(shape)


@register_op("uniform_random_batch_size_like", stateful=True,
             nondiff_inputs=("Input",))
def _uniform_random_bsl(ins, attrs):
    """reference: paddle/fluid/operators/uniform_random_batch_size_like_op.cc."""
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return {"Out": [draw(ins, attrs, _batch_shape(ins, attrs),
                         lambda b: prng.uniform(b, lo, hi),
                         first(ins, "Input").device)]}


@register_op("gaussian_random_batch_size_like", stateful=True,
             nondiff_inputs=("Input",))
def _gaussian_random_bsl(ins, attrs):
    """reference: paddle/fluid/operators/gaussian_random_batch_size_like_op.cc."""
    z = draw(ins, attrs, _batch_shape(ins, attrs), prng.normal,
             first(ins, "Input").device)
    return {"Out": [mean_std(z, attrs)]}
