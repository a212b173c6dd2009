"""``unique`` and ``unique_with_counts``, copied from the JAX package's
``layers/extra3.py``."""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["unique", "unique_with_counts"]


def _out(helper, dtype, stop_gradient=False):
    return helper.create_variable_for_type_inference(
        dtype, stop_gradient=stop_gradient
    )


def unique(x, dtype="int32"):
    """reference: python/paddle/fluid/layers/nn.py unique — returns
    (Out, Index). Static-shape contract: Out keeps x's length with the
    sorted unique values first (see ops/misc_extra.py ``_unique``)."""
    helper = LayerHelper("unique")
    out = _out(helper, x.dtype)
    index = _out(helper, dtype, stop_gradient=True)
    helper.append_op(
        "unique", {"X": [x.name]},
        {"Out": [out.name], "Index": [index.name]},
        {"dtype": dtype},
    )
    return out, index


def unique_with_counts(x, dtype="int32"):
    """reference: python/paddle/fluid/layers/nn.py unique_with_counts —
    returns (Out, Index, Count); same static-shape contract as unique."""
    helper = LayerHelper("unique_with_counts")
    out = _out(helper, x.dtype)
    index = _out(helper, dtype, stop_gradient=True)
    count = _out(helper, dtype, stop_gradient=True)
    helper.append_op(
        "unique_with_counts", {"X": [x.name]},
        {"Out": [out.name], "Index": [index.name], "Count": [count.name]},
        {"dtype": dtype},
    )
    return out, index, count
