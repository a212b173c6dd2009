"""Dygraph-to-static: TracedLayer, ``declarative`` and ``to_static``, as
the JAX package's ``dygraph/jit.py`` has them (reference:
python/paddle/fluid/dygraph/jit.py TracedLayer;
dygraph_to_static/ast_transformer.py). The same forward code traces into
a Program through the capture mode in ``base.py``; data-dependent ``if``
and loops are AST-converted first (``ast_transform.py``). The captured
Program runs on the port's Executor, on the guard's place, and exports
through ``io.save_inference_model`` in the JAX package's format."""

import numpy as np

from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.ir import Program, program_guard
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.dygraph.base import (
    _dygraph_tracer, no_grad_ctx, static_capture, to_variable)
from paddle_tpu_torch.dygraph.varbase import VarBase
from paddle_tpu_torch.utils import unique_name


class TracedLayer:
    """Static program captured from a dygraph Layer
    (reference: python/paddle/fluid/dygraph/jit.py TracedLayer). It runs
    on the place of the dygraph guard it was traced under."""

    def __init__(self, main_program, startup_program, feed_vars, fetch_vars):
        self._main = main_program
        self._startup = startup_program
        self._feed = feed_vars
        self._fetch = fetch_vars
        self._scope = Scope()
        tracer = _dygraph_tracer()
        self._exe = Executor(tracer.place if tracer is not None else None)
        with scope_guard(self._scope):
            self._exe.run(self._startup)

    @staticmethod
    def trace(layer, inputs):
        """Run `layer` once under capture; returns (dygraph_outputs,
        traced_layer)."""
        inputs = [inputs] if isinstance(inputs, VarBase) else list(inputs)
        # run once eagerly for the dygraph outputs
        dy_outs = layer(*inputs)

        main, startup = Program(), Program()
        with program_guard(main, startup), static_capture(main, startup) as cap:
            feed_vars = []
            proxies = []
            for vb in inputs:
                sv = main.global_block().create_var(
                    name=unique_name.generate("traced_feed"),
                    shape=list(vb.shape),
                    dtype=vb.dtype,
                    is_data=True,
                )
                proxy = VarBase.from_static(sv, stop_gradient=True)
                cap.var_map[id(proxy)] = sv
                feed_vars.append(sv)
                proxies.append(proxy)
            with no_grad_ctx():
                outs = layer(*proxies)
            outs_list = outs if isinstance(outs, (list, tuple)) else [outs]
            fetch_vars = [o.static_var for o in outs_list]
        return dy_outs, TracedLayer(main, startup, feed_vars, fetch_vars)

    def __call__(self, inputs):
        """Run the captured program: the inputs' tensors feed it as they
        are (on the card they stay there); the outputs come back as eager
        tensors."""
        inputs = [inputs] if isinstance(inputs, VarBase) else list(inputs)
        feed = {v.name: (vb.value if isinstance(vb, VarBase) else np.asarray(vb))
                for v, vb in zip(self._feed, inputs)}
        with scope_guard(self._scope):
            outs = self._exe.run(self._main, feed=feed,
                                 fetch_list=[f.name for f in self._fetch],
                                 return_numpy=False)
        return [to_variable(o) for o in outs]

    @property
    def program(self):
        return self._main

    def save_inference_model(self, dirname, feed=None, fetch=None):
        from paddle_tpu_torch import io

        feed_vars = self._feed if feed is None else [self._feed[i] for i in feed]
        fetch_vars = self._fetch if fetch is None else [self._fetch[i] for i in fetch]
        with scope_guard(self._scope):
            io.save_inference_model(
                dirname,
                [v.name for v in feed_vars],
                fetch_vars,
                self._exe,
                main_program=self._main,
            )


def _signature(args):
    sig = []
    for a in args:
        if isinstance(a, VarBase):
            sig.append(("var", tuple(a.shape), str(a.dtype)))
        elif isinstance(a, np.ndarray):
            sig.append(("np", a.shape, str(a.dtype)))
        else:
            sig.append(("const", a))
    return tuple(sig)


def declarative(fn):
    """Decorator: compile a dygraph function to a static program per input
    signature (reference: dygraph_to_static @declarative). Data-dependent
    `if` statements become both-branch `where` selection and loops `while`
    ops (ast_transform.py); control flow that cannot be converted keeps
    the loud capture-guard error."""
    from paddle_tpu_torch.dygraph.ast_transform import convert_ifelse

    traced_fn = convert_ifelse(fn)
    cache = {}

    def wrapper(*args):
        vb_args = [
            a if isinstance(a, VarBase) else to_variable(np.asarray(a)) for a in args
        ]
        key = _signature(vb_args)
        if key not in cache:

            class _FnLayer:
                def __call__(self, *xs):
                    return traced_fn(*xs)

            _, traced = TracedLayer.trace(_FnLayer(), vb_args)
            cache[key] = traced
        outs = cache[key](vb_args)
        return outs[0] if len(outs) == 1 else outs

    wrapper.__wrapped__ = fn
    return wrapper


to_static = declarative
