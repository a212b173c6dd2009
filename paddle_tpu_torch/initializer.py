"""Parameter initializers — emitted as startup-program ops.

Same architecture as the reference (reference: python/paddle/fluid/
initializer.py — initializers append fill_constant/uniform_random/... ops
to the startup program). The port carries constant, uniform, normal,
truncated normal, Xavier and MSRA (both forms); their random ops draw
``jax.random``'s values from the executor's keys, so a seed gives the JAX
package's startup weights.
"""

import math

from paddle_tpu_torch.utils.enforce import enforce


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": self.value},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": self.low,
                "max": self.high,
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
            },
        )


class TruncatedNormalInitializer(Initializer):
    """Normal draws truncated to two standard deviations, as the
    ``truncated_gaussian_random`` op (``ops/tensor.py``) makes them."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
            },
        )


def _fan_in_out(var):
    """reference: python/paddle/fluid/initializer.py _compute_fans — FC
    weights are [in, out]; conv filters are [out_c, in_c, *receptive]."""
    shape = var.shape
    enforce(len(shape) >= 1, "initializer needs a shaped variable")
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for d in shape[2:]:
        receptive *= d
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    """reference: python/paddle/fluid/initializer.py XavierInitializer."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fin, fout = _fan_in_out(var)
        fin = self.fan_in if self.fan_in is not None else fin
        fout = self.fan_out if self.fan_out is not None else fout
        if self.uniform:
            limit = math.sqrt(6.0 / (fin + fout))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fin + fout))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """Kaiming He init (reference: python/paddle/fluid/initializer.py
    MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fin, _ = _fan_in_out(var)
        fin = self.fan_in if self.fan_in is not None else fin
        if self.uniform:
            limit = math.sqrt(6.0 / fin)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fin)
            NormalInitializer(0.0, std, self.seed)(var, block)


# public aliases matching the reference API surface
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
