"""Gradient clipping as program rewrites, copied from the JAX package's
``clip.py`` (reference: python/paddle/fluid/clip.py — GradientClipByValue,
GradientClipByNorm, GradientClipByGlobalNorm). ``Optimizer(grad_clip=)``
calls the clip on the ``(param, grad)`` pairs before weight decay, at the
head of the optimize region."""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["GradientClipBase", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "ErrorClipByValue"]


class GradientClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    """Each grad element clipped to ``[min, max]`` (``min`` = -``max``
    when not given)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        from paddle_tpu_torch import layers

        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            out.append((p, layers.clip(g, self.min, self.max)))
        return out


class GradientClipByNorm(GradientClipBase):
    """Each grad scaled to at most ``clip_norm`` in l2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        from paddle_tpu_torch import layers

        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            out.append((p, layers.clip_by_norm(g, self.clip_norm)))
        return out


class GradientClipByGlobalNorm(GradientClipBase):
    """g_i *= clip_norm / max(global_norm, clip_norm), the global norm over
    every grad (``squared_l2_norm`` each, one ``sum``, ``sqrt``)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        from paddle_tpu_torch import layers
        from paddle_tpu_torch.layers import tensor

        helper = LayerHelper("global_norm_clip")
        sq_norms = []
        for p, g in params_grads:
            if g is None:
                continue
            sq = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op(
                "squared_l2_norm", {"X": [g.name]}, {"Out": [sq.name]},
                {"op_role": 1}
            )
            sq_norms.append(sq)
        if not sq_norms:
            return params_grads
        total = helper.create_variable_for_type_inference("float32")
        helper.append_op(
            "sum",
            {"X": [v.name for v in sq_norms]},
            {"Out": [total.name]},
            {"op_role": 1},
        )
        global_norm = layers.sqrt(total)
        clip_var = tensor.fill_constant([1], "float32", self.clip_norm)
        denom = layers.elementwise_max(global_norm, clip_var)
        scale_factor = layers.elementwise_div(clip_var, denom)
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            out.append((p, layers.elementwise_mul(g, scale_factor)))
        return out


def set_gradient_clip(clip, param_list=None, program=None):
    """Deprecated in the JAX package too: it warns and sets nothing (pass
    ``grad_clip=`` to the optimizer)."""
    import warnings

    warnings.warn("set_gradient_clip is deprecated; pass grad_clip= to the optimizer")


ErrorClipByValue = GradientClipByValue
