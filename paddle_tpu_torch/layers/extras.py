"""``hinge_loss`` and ``l2_normalize`` (over the ``norm`` op), copied from
the JAX package's ``layers/extras.py``. As there, this ``l2_normalize``
is the one ``layers`` exports (``layers/nn.py`` has the composite
form)."""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["hinge_loss", "l2_normalize"]


def hinge_loss(logits, labels, name=None):
    """reference: paddle/fluid/operators/hinge_loss_op.cc."""
    helper = LayerHelper("hinge_loss", name=name)
    out = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "hinge_loss", {"Logits": [logits.name], "Labels": [labels.name]},
        {"Loss": [out.name]}, {},
    )
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """reference: python/paddle/fluid/layers/nn.py l2_normalize (norm op)."""
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference("float32",
                                                     stop_gradient=True)
    helper.append_op(
        "norm", {"X": [x.name]},
        {"Out": [out.name], "Norm": [norm.name]},
        {"axis": 1 if axis is None else axis, "epsilon": epsilon},
    )
    return out
