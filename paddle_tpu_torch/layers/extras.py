"""``hinge_loss``, copied from the JAX package's ``layers/extras.py``."""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["hinge_loss"]


def hinge_loss(logits, labels, name=None):
    """reference: paddle/fluid/operators/hinge_loss_op.cc."""
    helper = LayerHelper("hinge_loss", name=name)
    out = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "hinge_loss", {"Logits": [logits.name], "Labels": [labels.name]},
        {"Loss": [out.name]}, {},
    )
    return out
