"""Optimizers: append_backward + update ops, as program transforms.

Same architecture as the JAX package's ``optimizer.py`` and the reference
(reference: python/paddle/fluid/optimizer.py:54 Optimizer — backward :608,
apply_gradients :672, minimize :780): ``minimize()`` rewrites the program
with grad ops, then appends one update op per parameter, with
accumulators as persistable vars initialized in the startup program. Var
names and op attributes follow the JAX package's, so both packages build
the same training program. The port carries ``SGDOptimizer``,
``MomentumOptimizer``, ``AdamOptimizer`` and ``DGCMomentumOptimizer``,
with weight decay (``regularizer.py``: ``regularization=`` for every
parameter, a parameter's own ``ParamAttr(regularizer=)`` first); gradient
clipping and per-parameter learning rates are not ported yet (ROADMAP
M1b). In dygraph mode ``minimize(loss, parameter_list=)`` runs a static
apply program over the eager parameters (``_dygraph_minimize``).
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
           "Momentum", "AdamOptimizer", "Adam", "DGCMomentumOptimizer"]

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
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP M1b)")
        self._learning_rate = learning_rate
        self.regularization = regularization
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
        if param.optimize_attr.get("learning_rate", 1.0) != 1.0:
            raise NotImplementedError(
                "per-parameter learning rates are not ported yet (ROADMAP M1b)")
        return self._lr_var

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
        params_grads = self._append_regularization(params_grads)
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = []
        for p, g in params_grads:
            if g is None:
                continue
            ops.append(self._append_optimize_op(block, (p, g)))
        self._finish_update(block, params_grads)
        # everything appended here (regularization included) is the
        # optimize region
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
            {
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
                "op_role": _OP_ROLE_OPTIMIZE,
            },
        )


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


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
