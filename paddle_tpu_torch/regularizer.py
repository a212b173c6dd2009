"""Weight-decay regularizers appended as grad-side ops (reference:
python/paddle/fluid/regularizer.py), copied from the JAX package's
``regularizer.py``: the same ``scale`` (and ``sign``) and ``sum`` ops,
var names and attributes, so both packages build the same training
program. ``Optimizer(regularization=)`` applies one to every parameter;
``ParamAttr(regularizer=)`` takes precedence for its parameter."""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["WeightDecayRegularizer", "L2DecayRegularizer",
           "L1DecayRegularizer", "L2Decay", "L1Decay"]


class WeightDecayRegularizer:
    def _append_regularization_op(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """``grad + coeff * param``."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_regularization_op(self, param, grad):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op(
            "scale",
            {"X": [param.name]},
            {"Out": [decay.name]},
            {"scale": self._coeff, "op_role": 1},
        )
        out = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op(
            "sum",
            {"X": [grad.name, decay.name]},
            {"Out": [out.name]},
            {"op_role": 1},
        )
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    """``grad + coeff * sign(param)``."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_regularization_op(self, param, grad):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op("sign", {"X": [param.name]}, {"Out": [sign.name]},
                         {"op_role": 1})
        decay = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op(
            "scale",
            {"X": [sign.name]},
            {"Out": [decay.name]},
            {"scale": self._coeff, "op_role": 1},
        )
        out = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op(
            "sum", {"X": [grad.name, decay.name]}, {"Out": [out.name]},
            {"op_role": 1}
        )
        return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
