"""Optimizers: append_backward + update ops, as program transforms.

Same architecture as the JAX package's ``optimizer.py`` and the reference
(reference: python/paddle/fluid/optimizer.py:54 Optimizer — backward :608,
apply_gradients :672, minimize :780): ``minimize()`` rewrites the program
with grad ops, then appends one update op per parameter, with
accumulators as persistable vars initialized in the startup program. Var
names and op attributes follow the JAX package's, so both packages build
the same training program. The port carries the JAX package's update
rules (``ops/optimizers.py``): SGD, Momentum, LarsMomentum, Adagrad, Adam,
AdamW, Lamb, Adamax, Adadelta, DecayedAdagrad, RMSProp, Ftrl, Dpsgd and
DGCMomentum; ``ExponentialMovingAverage`` and ``ModelAverage`` with their
``apply``; ``RecomputeOptimizer`` (remat, ``ops/recompute.py``). The
optimize region is, in order: the gradient clip (``grad_clip=``,
``clip.py``), weight decay (``regularizer.py``: ``regularization=`` for
every parameter, a parameter's own ``ParamAttr(regularizer=)`` first),
the per-parameter learning rate (``ParamAttr(learning_rate=)``, a
``scale`` of the global rate) and the update ops. ``PipelineOptimizer``
raises (ROADMAP M11). In dygraph mode ``minimize(loss, parameter_list=)``
runs a static apply program over the eager parameters
(``_dygraph_minimize``).
"""

from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.core.ir import (
    Variable, default_main_program, default_startup_program)
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import tensor as tensor_layers
from paddle_tpu_torch.utils import unique_name
from paddle_tpu_torch.utils.enforce import EnforceError
from paddle_tpu_torch.utils.flags import flags

__all__ = ["Optimizer", "SGDOptimizer", "SGD", "MomentumOptimizer",
           "Momentum", "LarsMomentumOptimizer", "LarsMomentum",
           "AdagradOptimizer", "Adagrad", "AdamOptimizer", "Adam",
           "AdamWOptimizer", "AdamW", "LambOptimizer", "Lamb",
           "AdamaxOptimizer", "Adamax", "AdadeltaOptimizer", "Adadelta",
           "DecayedAdagradOptimizer", "DecayedAdagrad", "RMSPropOptimizer",
           "RMSProp", "FtrlOptimizer", "Ftrl", "DpsgdOptimizer", "Dpsgd",
           "DGCMomentumOptimizer", "RecomputeOptimizer", "PipelineOptimizer",
           "ExponentialMovingAverage", "ModelAverage"]

#: accumulator slot names (the JAX package's set): the suffixes by which
#: ``parallel/sharding.py`` finds a slot's parameter; ``_add_accumulator``
#: adds any other slot it makes
ACCUMULATOR_SLOT_NAMES = {
    "velocity", "moment", "moment1", "moment2",
    "beta1_pow_acc", "beta2_pow_acc", "inf_norm",
    "_avg_squared_grad", "_avg_squared_update",
    "momentum", "mean_square", "mean_grad",
    "squared", "linear", "dgc_u", "dgc_v",
}

_OP_ROLE_OPTIMIZE = 2


class Optimizer:
    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._accumulators = {}
        self._lr_var = None
        self.helper = None

    # -- learning rate ------------------------------------------------
    def _create_global_learning_rate(self):
        if self._lr_var is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
        else:
            self._lr_var = tensor_layers.create_global_var(
                shape=[1],
                value=float(self._learning_rate),
                dtype="float32",
                persistable=True,
                name=unique_name.generate("learning_rate"),
            )

    def _param_lr(self, param):
        """The global rate, or ``scale(lr, plr)`` for a parameter whose
        ``ParamAttr(learning_rate=plr)`` is not 1."""
        plr = param.optimize_attr.get("learning_rate", 1.0)
        if plr == 1.0:
            return self._lr_var
        from paddle_tpu_torch import layers

        return layers.scale(self._lr_var, scale=float(plr))

    # -- accumulators -------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, dtype="float32",
                         shape=None):
        ACCUMULATOR_SLOT_NAMES.add(name)
        acc = self._accumulators.setdefault(name, {})
        if param.name in acc:
            return acc[param.name]
        var_name = unique_name.generate(f"{param.name}_{name}")
        shape = shape if shape is not None else list(param.shape)
        main_block = default_main_program().global_block()
        var = main_block.create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True
        )
        var.stop_gradient = True
        sblock = default_startup_program().global_block()
        sblock.create_var(name=var_name, shape=shape, dtype=dtype, persistable=True)
        sblock.append_op(
            "fill_constant",
            {},
            {"Out": [var_name]},
            {"shape": shape, "dtype": dtype, "value": fill_value},
        )
        acc[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    # -- pipeline -----------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def _append_regularization(self, params_grads):
        out = []
        for p, g in params_grads:
            reg = p.regularizer or self.regularization
            if reg is None or g is None:
                out.append((p, g))
                continue
            out.append((p, reg._append_regularization_op(p, g)))
        return out

    def apply_gradients(self, params_grads):
        block = default_main_program().global_block()
        start = len(block.ops)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        params_grads = self._append_regularization(params_grads)
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = []
        for p, g in params_grads:
            if g is None:
                continue
            ops.append(self._append_optimize_op(block, (p, g)))
        self._finish_update(block, params_grads)
        # everything appended here (clip, regularization, lr scaling and
        # the updates) is the optimize region
        for op in block.ops[start:]:
            op.attrs["op_role"] = _OP_ROLE_OPTIMIZE
        return ops

    def _finish_update(self, block, params_grads):
        pass

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from paddle_tpu_torch.dygraph.base import in_dygraph_mode

        if in_dygraph_mode():
            return self._dygraph_minimize(loss, parameter_list)
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        params_grads = self.backward(
            loss, startup_program, parameter_list, no_grad_set
        )
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    # -- dygraph path --------------------------------------------------
    # As in the JAX package: the SAME _append_optimize_op machinery builds
    # a static "apply program" once per parameter set (all updates + lr +
    # regularization), run by the port's Executor on the guard's place
    # with the accumulators in a private Scope. The parameters and grads
    # feed it as the tensors they are and the updated parameters come
    # back as tensors: they stay on the card, no host round trip a step.
    def _dygraph_minimize(self, loss, parameter_list):
        from paddle_tpu_torch.core.executor import Executor
        from paddle_tpu_torch.core.ir import Program, program_guard
        from paddle_tpu_torch.core.scope import Scope, scope_guard
        from paddle_tpu_torch.dygraph.base import _dygraph_tracer

        if parameter_list is None:
            raise EnforceError(
                "parameter_list is required for minimize() in dygraph mode "
                "(pass layer.parameters())")
        params = [
            p
            for p in parameter_list
            if getattr(p, "trainable", True) and p.grad_value is not None
        ]
        if not params:
            return [], []
        key = tuple((p.name, tuple(p.shape), str(p.dtype)) for p in params)
        if getattr(self, "_dy_key", None) != key:
            self._dy_scope = Scope()
            self._dy_exe = Executor(_dygraph_tracer().place)
            main, startup = Program(), Program()
            self._lr_var = None
            self._accumulators = {}
            self.helper = LayerHelper(self.__class__.__name__)
            with program_guard(main, startup):
                self._create_global_learning_rate()
                block = main.global_block()
                params_grads = []
                for p in params:
                    sp = block.create_parameter(
                        shape=list(p.shape), dtype=p.dtype, name=p.name
                    )
                    sp.optimize_attr = dict(p.optimize_attr)
                    sp.regularizer = p.regularizer
                    g = block.create_var(
                        name=p.name + "@GRAD", shape=list(p.shape), dtype=p.dtype
                    )
                    params_grads.append((sp, g))
                self.apply_gradients(params_grads)
            with scope_guard(self._dy_scope):
                self._dy_exe.run(startup)
            self._dy_prog = main
            self._dy_key = key
        feed = {p.name: p.value for p in params}
        for p in params:
            feed[p.name + "@GRAD"] = p.grad_value
        with scope_guard(self._dy_scope):
            outs = self._dy_exe.run(
                self._dy_prog,
                feed=feed,
                fetch_list=[p.name for p in params],
                return_numpy=False,
            )
        for p, v in zip(params, outs):
            p.value = v
        return [], [(p, p.grad_value) for p in params]

    def state_dict(self):
        """Dygraph accumulator state, as numpy (reference: dygraph
        optimizer state_dict)."""
        from paddle_tpu_torch.dygraph.base import to_numpy

        out = {}
        scope = getattr(self, "_dy_scope", None)
        if scope is None:
            return out
        for per_param in self._accumulators.values():
            for var in per_param.values():
                val = scope.find_var(var.name)
                if val is not None:
                    out[var.name] = to_numpy(val)
        if self._lr_var is not None:
            val = scope.find_var(self._lr_var.name)
            if val is not None:
                out[self._lr_var.name] = to_numpy(val)
        return out

    def set_state_dict(self, state_dict):
        import numpy as np
        import torch

        scope = getattr(self, "_dy_scope", None)
        if scope is None:
            raise EnforceError("optimizer has no state yet (run a step first)")
        device = self._dy_exe.device
        for name, val in state_dict.items():
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.array(val))
            scope.set(name, val.to(device))

    set_dict = set_state_dict

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "LearningRate": [self._param_lr(p).name],
            },
            {"ParamOut": [p.name]},
            {"op_role": _OP_ROLE_OPTIMIZE},
        )

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = super().minimize(
            loss, startup_program, parameter_list, no_grad_set
        )
        from paddle_tpu_torch.dygraph.base import in_dygraph_mode

        if not in_dygraph_mode() and flags.sparse_embedding_update:
            # SelectedRows analog (reference: operators/optimizers/sgd_op.h
            # sparse branch): single-use embedding grads become row-sparse
            # updates instead of [V, D] dense tensors. The rewrite is
            # deferred to the first run (``Executor.run`` applies it), as
            # in the JAX package.
            loss.block.program._wants_sparse_embedding = True
        return result


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "Velocity": [velocity.name],
                "LearningRate": [self._param_lr(p).name],
            },
            {"ParamOut": [p.name], "VelocityOut": [velocity.name]},
            {
                "mu": self._momentum,
                "use_nesterov": self._use_nesterov,
                "op_role": _OP_ROLE_OPTIMIZE,
            },
        )


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "Velocity": [velocity.name],
                "LearningRate": [self._param_lr(p).name],
            },
            {"ParamOut": [p.name], "VelocityOut": [velocity.name]},
            {
                "mu": self._momentum,
                "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay,
                "epsilon": self._epsilon,
                "op_role": _OP_ROLE_OPTIMIZE,
            },
        )


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "Moment": [moment.name],
                "LearningRate": [self._param_lr(p).name],
            },
            {"ParamOut": [p.name], "MomentOut": [moment.name]},
            {"epsilon": self._epsilon, "op_role": _OP_ROLE_OPTIMIZE},
        )


class AdamOptimizer(Optimizer):
    _op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _op_attrs(self, param):
        return {
            "beta1": self._beta1,
            "beta2": self._beta2,
            "epsilon": self._epsilon,
            "op_role": _OP_ROLE_OPTIMIZE,
        }

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            self._op_type,
            {
                "Param": [p.name],
                "Grad": [g.name],
                "Moment1": [m1.name],
                "Moment2": [m2.name],
                "Beta1Pow": [b1p.name],
                "Beta2Pow": [b2p.name],
                "LearningRate": [self._param_lr(p).name],
            },
            {
                "ParamOut": [p.name],
                "Moment1Out": [m1.name],
                "Moment2Out": [m2.name],
                "Beta1PowOut": [b1p.name],
                "Beta2PowOut": [b2p.name],
            },
            self._op_attrs(p),
        )


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay (``coeff``)."""

    _op_type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._coeff = weight_decay

    def _op_attrs(self, param):
        return dict(super()._op_attrs(param), coeff=self._coeff)


class LambOptimizer(AdamOptimizer):
    """LAMB (reference: python/paddle/fluid/optimizer.py LambOptimizer):
    Adam's moments with a layer-wise trust ratio. A parameter for which
    ``exclude_from_weight_decay_fn(param)`` is true gets weight decay 0."""

    _op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _op_attrs(self, param):
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(param):
            wd = 0.0
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon, "weight_decay": wd,
                "op_role": _OP_ROLE_OPTIMIZE}


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adamax",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "Moment": [self._get_accumulator("moment", p).name],
                "InfNorm": [self._get_accumulator("inf_norm", p).name],
                "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p).name],
                "LearningRate": [self._param_lr(p).name],
            },
            {
                "ParamOut": [p.name],
                "MomentOut": [self._get_accumulator("moment", p).name],
                "InfNormOut": [self._get_accumulator("inf_norm", p).name],
            },
            {
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
                "op_role": _OP_ROLE_OPTIMIZE,
            },
        )

    def _finish_update(self, block, params_grads):
        """beta1_pow *= beta1 after all updates
        (reference: python/paddle/fluid/optimizer.py Adamax._finish_update)."""
        for p, g in params_grads:
            if g is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(
                "scale",
                {"X": [b1p.name]},
                {"Out": [b1p.name]},
                {"scale": self._beta1, "op_role": _OP_ROLE_OPTIMIZE},
            )


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("_avg_squared_grad", p)
            self._add_accumulator("_avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("_avg_squared_grad", p)
        asu = self._get_accumulator("_avg_squared_update", p)
        return block.append_op(
            "adadelta",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "AvgSquaredGrad": [asg.name],
                "AvgSquaredUpdate": [asu.name],
            },
            {
                "ParamOut": [p.name],
                "AvgSquaredGradOut": [asg.name],
                "AvgSquaredUpdateOut": [asu.name],
            },
            {"epsilon": self._epsilon, "rho": self._rho,
             "op_role": _OP_ROLE_OPTIMIZE},
        )


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "Moment": [moment.name],
                "LearningRate": [self._param_lr(p).name],
            },
            {"ParamOut": [p.name], "MomentOut": [moment.name]},
            {"decay": self._decay, "epsilon": self._epsilon,
             "op_role": _OP_ROLE_OPTIMIZE},
        )


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        return block.append_op(
            "rmsprop",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "Moment": [mom.name],
                "MeanSquare": [ms.name],
                "MeanGrad": [mg.name],
                "LearningRate": [self._param_lr(p).name],
            },
            {
                "ParamOut": [p.name],
                "MomentOut": [mom.name],
                "MeanSquareOut": [ms.name],
                "MeanGradOut": [mg.name],
            },
            {
                "decay": self._rho,
                "epsilon": self._epsilon,
                "momentum": self._momentum,
                "centered": self._centered,
                "op_role": _OP_ROLE_OPTIMIZE,
            },
        )


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "SquaredAccumulator": [sq.name],
                "LinearAccumulator": [lin.name],
                "LearningRate": [self._param_lr(p).name],
            },
            {
                "ParamOut": [p.name],
                "SquaredAccumOut": [sq.name],
                "LinearAccumOut": [lin.name],
            },
            {
                "l1": self._l1,
                "l2": self._l2,
                "lr_power": self._lr_power,
                "op_role": _OP_ROLE_OPTIMIZE,
            },
        )


class DpsgdOptimizer(Optimizer):
    """Differentially private SGD: each grad clipped to ``clip`` in norm,
    plus Gaussian noise of ``sigma * clip / batch_size`` drawn from the
    run's key (on the card through K8's ``random_bits``)."""

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "dpsgd",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "LearningRate": [self._param_lr(p).name],
            },
            {"ParamOut": [p.name]},
            {
                "clip": self._clip,
                "batch_size": self._batch_size,
                "sigma": self._sigma,
                "op_role": _OP_ROLE_OPTIMIZE,
            },
        )


class RecomputeOptimizer(Optimizer):
    """Activation recomputation (reference: python/paddle/fluid/
    optimizer.py:3714 RecomputeOptimizer + backward.py:618
    _append_backward_ops_with_checkpoints_), as in the JAX package: the
    checkpoints and the policy are recorded on the program, and
    ``append_backward`` collapses each forward segment between two
    checkpoints into one ``recompute_segment_grad`` op that replays it at
    backward time (``core/backward.py`` ``_collapse_segments``,
    ``ops/recompute.py``). The executor drops a segment's interior values
    after their last forward reader, but for what ``policy`` keeps
    (``kernels/remat.py``: ``full``, the default, keeps nothing;
    ``dots`` / ``dots_no_batch`` keep the products' outputs, which the
    replay does not recompute; ``save_all`` keeps everything). The
    grads are the same bits with or without recompute, under every
    policy."""

    def __init__(self, optimizer, policy=None):
        from paddle_tpu_torch.kernels import remat as _remat

        self._inner = optimizer
        self._checkpoints = None
        self._policy = _remat.validate_policy(
            policy or _remat.DEFAULT_POLICY)

    def _set_checkpoints(self, checkpoints, policy=None):
        from paddle_tpu_torch.kernels import remat as _remat

        self._checkpoints = [
            c if isinstance(c, str) else c.name for c in checkpoints
        ]
        if policy is not None:
            self._policy = _remat.validate_policy(policy)

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def _arm(self, program):
        program._recompute_checkpoints = list(self._checkpoints)
        program._recompute_policy = self._policy

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        if self._checkpoints:
            self._arm(loss.block.program)
        return self._inner.backward(
            loss, startup_program, parameter_list, no_grad_set
        )

    def apply_gradients(self, params_grads):
        return self._inner.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if self._checkpoints:
            self._arm(loss.block.program)
        return self._inner.minimize(
            loss, startup_program, parameter_list, no_grad_set
        )


class PipelineOptimizer:
    """Microbatch-pipelined training over the whole program (the JAX
    package's ``PipelineOptimizer``, its executor's microbatched step):
    not ported yet (ROADMAP M11). ``layers.pipeline_stack`` with
    ``CompiledProgram.with_parallel`` over a ``stage`` axis runs the
    pipeline the port has."""

    def __init__(self, optimizer, num_microbatches=1, *args, **kwargs):
        raise NotImplementedError(
            "PipelineOptimizer (the microbatched step) is not ported yet "
            "(ROADMAP M11)")


class DGCMomentumOptimizer(MomentumOptimizer):
    """Momentum with Deep Gradient Compression (reference: python/paddle/
    fluid/optimizer.py:1042 DGCMomentumOptimizer; paddle/fluid/operators/
    dgc_op.cc; details/sparse_all_reduce_op_handle.h).

    One ``dgc_momentum`` op per parameter with accumulators ``dgc_u`` and
    ``dgc_v`` and one ``dgc_step`` counter (the JAX package's names), which
    an ``increment`` at the end of the update region advances. Under a
    data-parallel ``CompiledProgram`` over two or more ranks, U/V become
    per-rank error-feedback state and the exchange is a top-k (index,
    value) all-gather (``ops/optimizers.py``); run by a plain ``Executor``
    it is the fused dense form."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, momentum,
                         use_nesterov=use_nesterov,
                         regularization=regularization,
                         grad_clip=grad_clip, name=name)
        self._rampup_begin_step = rampup_begin_step
        self._rampup_step = rampup_step
        self._sparsity = [float(s) for s in sparsity]
        self._step_var = None

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)
        if self._step_var is None:
            self._step_var = tensor_layers.create_global_var(
                shape=[1], value=0.0, dtype="float32", persistable=True,
                name=unique_name.generate("dgc_step"),
            )

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "dgc_momentum",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "U": [self._get_accumulator("dgc_u", p).name],
                "V": [self._get_accumulator("dgc_v", p).name],
                "LearningRate": [self._param_lr(p).name],
                "CurrentStep": [self._step_var.name],
            },
            {
                "ParamOut": [p.name],
                "UOut": [self._get_accumulator("dgc_u", p).name],
                "VOut": [self._get_accumulator("dgc_v", p).name],
            },
            {
                "mu": self._momentum,
                "use_nesterov": self._use_nesterov,
                "rampup_begin_step": float(self._rampup_begin_step),
                "rampup_step": float(self._rampup_step),
                "sparsity": self._sparsity,
                "op_role": _OP_ROLE_OPTIMIZE,
            },
        )

    def _finish_update(self, block, params_grads):
        block.append_op(
            "increment",
            {"X": [self._step_var.name]},
            {"Out": [self._step_var.name]},
            {"step": 1.0, "op_role": _OP_ROLE_OPTIMIZE},
        )


class ExponentialMovingAverage:
    """EMA of trainable parameters (reference: python/paddle/fluid/
    optimizer.py:3166), as the JAX package has it: ``update()`` appends
    in-graph shadow updates (``ema_update``) to the main program, run every
    step after the optimizer ops; ``apply()`` is a context manager that
    swaps the shadows into the global scope and puts the parameters back
    on exit. ``thres_steps`` is accepted and not applied: the decay is
    constant, as in the JAX package."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._shadows = {}  # param name -> shadow var name

    def update(self):
        block = default_main_program().global_block()
        sblock = default_startup_program().global_block()
        for p in block.all_parameters():
            if not p.trainable:
                continue
            sname = unique_name.generate(f"{self._name}_{p.name}")
            self._shadows[p.name] = sname
            shape = list(p.shape)
            block.create_var(name=sname, shape=shape, dtype=p.dtype,
                             persistable=True).stop_gradient = True
            sblock.create_var(name=sname, shape=shape, dtype=p.dtype,
                              persistable=True)
            # the shadow starts at the initial parameter value
            sblock.append_op("assign", {"X": [p.name]}, {"Out": [sname]}, {})
            block.append_op(
                "ema_update",
                {"Param": [p.name], "Shadow": [sname]},
                {"ShadowOut": [sname]},
                {"decay": self._decay, "op_role": _OP_ROLE_OPTIMIZE},
            )

    def apply(self, executor=None, need_restore=True):
        return _swap_in({pname: sname for pname, sname
                         in self._shadows.items()}, need_restore,
                        lambda scope, sname: scope.find_var(sname))

    def restore(self, executor=None):
        pass  # restoration is handled by the apply() context exit


class ModelAverage:
    """Sliding-window parameter averaging (reference: python/paddle/fluid/
    optimizer.py:2862), as the JAX package has it: running sums in-graph
    (``model_average_update``; the count var holds (window count, total
    updates)); ``apply()`` swaps ``sum / window count`` in for evaluation.
    The window is clamp(average_window_rate * updates, min_average_window,
    max_average_window); at the window the sum decays geometrically."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, name=None):
        self._name = name or "model_avg"
        self._rate = float(average_window_rate)
        self._min_window = float(min_average_window)
        self._max_window = float(max_average_window)
        self._sums = {}  # param -> (sum var, count var)

    def _build(self):
        block = default_main_program().global_block()
        sblock = default_startup_program().global_block()
        for p in block.all_parameters():
            if not p.trainable:
                continue
            ssum = unique_name.generate(f"{self._name}_sum_{p.name}")
            scnt = unique_name.generate(f"{self._name}_cnt_{p.name}")
            for name, shape in ((ssum, list(p.shape)), (scnt, [2])):
                block.create_var(name=name, shape=shape, dtype="float32",
                                 persistable=True).stop_gradient = True
                sblock.create_var(name=name, shape=shape, dtype="float32",
                                  persistable=True)
                sblock.append_op(
                    "fill_constant", {}, {"Out": [name]},
                    {"shape": shape, "dtype": "float32", "value": 0.0},
                )
            self._sums[p.name] = (ssum, scnt)
            block.append_op(
                "model_average_update",
                {"Param": [p.name], "Sum": [ssum], "Count": [scnt]},
                {"SumOut": [ssum], "CountOut": [scnt]},
                {"rate": self._rate,
                 "min_window": self._min_window,
                 "max_window": self._max_window,
                 "op_role": _OP_ROLE_OPTIMIZE},
            )

    def minimize_after(self, optimizer_result=None):
        """Call once after optimizer.minimize() to append averaging ops."""
        self._build()

    def apply(self, executor=None, need_restore=True):
        def average(scope, names):
            import torch

            ssum, scnt = names
            s, c = scope.find_var(ssum), scope.find_var(scnt)
            if s is None or c is None:
                return None
            cnt = float(c.reshape(-1)[0])          # the window count
            if cnt <= 0:
                return None
            # a 0-d divisor: a true division, as numpy's
            return s / torch.full((), cnt, dtype=s.dtype, device=s.device)

        return _swap_in(dict(self._sums), need_restore, average)

    def restore(self, executor=None):
        pass


def _swap_in(sources, need_restore, value_of):
    """A context that sets each parameter ``p`` of ``sources`` to
    ``value_of(scope, sources[p])`` in the global scope (None: left as
    it is) and, with ``need_restore``, puts the parameters back on
    exit."""
    import contextlib

    from paddle_tpu_torch.core.scope import global_scope

    @contextlib.contextmanager
    def _ctx():
        scope = global_scope()
        saved = {}
        for pname, src in sources.items():
            value = value_of(scope, src)
            if value is None:
                continue
            saved[pname] = scope.find_var(pname)
            scope.set(pname, value)
        try:
            yield
        finally:
            if need_restore:
                for pname, val in saved.items():
                    scope.set(pname, val)

    return _ctx()


SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Lamb = LambOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Dpsgd = DpsgdOptimizer
