"""Gradient clipping, per-parameter learning rates and the learning-rate
schedules of the PyTorch port (M1b) against the JAX package, on the CPU:

* the ops ``clip_by_norm`` (over and under its bound), ``squared_l2_norm``
  and ``norm``, forward and grad, against the JAX lowerings (rtol 1e-5,
  atol 1e-6; grads rtol = atol = 1e-5, ``tests/test_torch_train_ops.py``'s
  bars);
* ``GradientClipByValue``, ``GradientClipByNorm`` and
  ``GradientClipByGlobalNorm`` through ``Optimizer(grad_clip=)``, and
  ``ParamAttr(learning_rate=)``: the same programs as the JAX package (the
  clip before weight decay), and 3 steps from the JAX startup's state
  agree: the clipped grads and the parameters within rtol 1e-5, atol 1e-6;
* the eight schedules (``noam_decay``, ``exponential_decay``,
  ``natural_exp_decay``, ``inverse_time_decay`` with and without
  ``staircase``, ``polynomial_decay``, ``piecewise_decay``,
  ``cosine_decay``, ``linear_lr_warmup``): the same programs, and the
  learning rate value by value over 12 steps within rtol 1e-6, atol
  1e-8 (a schedule that decays to 0 ends at float32 rounding of 0);
* ``l2_normalize`` in both of the JAX package's forms (``layers`` over the
  ``norm`` op; ``layers.nn`` as a composite).
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.utils import unique_name as torch_names

from test_torch_train_ops import _assert_same, _grad_op, _run_jax, _run_torch

R = np.random.RandomState(31)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


# op type -> (inputs, attrs)
CASES = {
    "clip_by_norm": ({"X": [f32(4, 5)]}, {"max_norm": 1.5}),
    "squared_l2_norm": ({"X": [f32(3, 4)]}, {}),
    "norm": ({"X": [f32(2, 3, 4)]}, {"axis": 1, "epsilon": 1e-10}),
}
EXTRA = {
    "clip_by_norm_under": ("clip_by_norm", {"X": [f32(4, 5) * 0.01]},
                           {"max_norm": 1.5}),
    "norm_last_axis": ("norm", {"X": [f32(3, 6)]},
                       {"axis": -1, "epsilon": 1e-12}),
}
ALL = dict({k: (k, *v) for k, v in CASES.items()}, **EXTRA)


@pytest.mark.parametrize("case", sorted(ALL))
def test_op_matches_jax_lowering(case):
    op_type, ins, attrs = ALL[case]
    _assert_same(_run_torch(op_type, ins, attrs),
                 _run_jax(op_type, ins, attrs))


@pytest.mark.parametrize("case", sorted(ALL))
def test_grad_matches_jax_vjp(case):
    op_type, ins, attrs = ALL[case]
    gins, gattrs = _grad_op(op_type, ins, attrs)
    _assert_same(_run_torch(op_type + "_grad", gins, gattrs),
                 _run_jax(op_type + "_grad", gins, gattrs),
                 rtol=1e-5, atol=1e-5)


# -- clip classes and per-parameter learning rates --------------------------------

CLIPS = {
    "value": lambda m: m.clip.GradientClipByValue(0.05),
    "value_min": lambda m: m.clip.GradientClipByValue(0.08, min=-0.02),
    "norm": lambda m: m.clip.GradientClipByNorm(0.1),
    "global_norm": lambda m: m.clip.GradientClipByGlobalNorm(0.2),
    "global_norm_l2": lambda m: m.clip.GradientClipByGlobalNorm(0.2),
    "param_lr": lambda m: None,
}
STEPS = 3


def _net(mod, names, which):
    main, startup = mod.Program(), mod.Program()
    main.random_seed = startup.random_seed = 3
    with names.guard(), mod.program_guard(main, startup):
        x = mod.data("x", shape=[-1, 6])
        y = mod.data("y", shape=[-1, 1])
        h = mod.layers.fc(x, size=5, act="relu", param_attr=mod.ParamAttr(
            learning_rate=0.5 if which == "param_lr" else 1.0))
        pred = mod.layers.fc(h, size=1)
        loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
        reg = (mod.regularizer.L2Decay(1e-2) if which == "global_norm_l2"
               else None)
        opt = mod.optimizer.Momentum(0.02, 0.9, regularization=reg,
                                     grad_clip=CLIPS[which](mod))
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, [g.name for _, g in params_grads]


@pytest.mark.parametrize("which", sorted(CLIPS))
def test_clip_and_param_lr_match_the_jax_package(which):
    jmain, jstartup, jloss, jgrads = _net(fluid, jax_names, which)
    tmain, tstartup, tloss, tgrads = _net(pt, torch_names, which)
    for j, t in ((jmain, tmain), (jstartup, tstartup)):
        assert [op.desc() for op in t.global_block().ops] == \
            [op.desc() for op in j.global_block().ops]
    types = [op.type for op in tmain.global_block().ops]
    if which != "param_lr":
        # the clip comes before the weight decay and the updates
        first_opt = min(i for i, op in enumerate(tmain.global_block().ops)
                        if op.attrs.get("op_role") == 2)
        assert types[first_opt] in ("clip", "clip_by_norm",
                                    "squared_l2_norm")
    else:
        assert "scale" in types[types.index("fill_constant", 1):]
    rng = np.random.RandomState(7)
    x = rng.randn(8, 6).astype(np.float32) * 3
    feed = {"x": x, "y": x.sum(1, keepdims=True).astype(np.float32)}
    # the raw grads and what the clip made of them
    clipped = [op.output("Out")[0] for op in tmain.global_block().ops
               if op.type in ("clip", "clip_by_norm")
               or (op.type == "elementwise_mul"
                   and op.attrs.get("op_role") == 2)]
    assert len(clipped) == (0 if which == "param_lr" else len(jgrads))
    fetch = [jloss.name] + jgrads + clipped
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.asarray(jscope.find_var(v.name))
                 for v in jmain.global_block().vars.values()
                 if v.persistable and jscope.find_var(v.name) is not None}
        jout = [[np.asarray(a) for a in jexe.run(jmain, feed=feed,
                                                 fetch_list=fetch)]
                for _ in range(STEPS)]
        jstate = {n: np.asarray(jscope.find_var(n)) for n in state}
    texe, tscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    load_params(tscope, state)
    tout = [texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
            for _ in range(STEPS)]
    for step_t, step_j in zip(tout, jout):
        for name, g, w in zip(fetch, step_t, step_j):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    tstate = persistables_to_numpy(tscope, tmain)
    for name, want in jstate.items():
        np.testing.assert_allclose(tstate[name], want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    if which.startswith("value"):
        lo, hi = (-0.02, 0.08) if which == "value_min" else (-0.05, 0.05)
        outs = [o for step in tout for o in step[1 + len(jgrads):]]
        assert all(c.min() >= lo and c.max() <= hi for c in outs)
        raw = [o for step in tout for o in step[1:1 + len(jgrads)]]
        assert any(r.max() > hi or r.min() < lo for r in raw)


def test_set_gradient_clip_warns_and_error_clip_is_the_value_clip():
    with pytest.warns(UserWarning, match="grad_clip"):
        pt.clip.set_gradient_clip(pt.clip.GradientClipByValue(1.0))
    assert pt.clip.ErrorClipByValue is pt.clip.GradientClipByValue


# -- the schedules ----------------------------------------------------------------

SCHEDULES = {
    "noam": lambda s: s.noam_decay(64, 4),
    "exponential": lambda s: s.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda s: s.exponential_decay(0.1, 3, 0.5,
                                                           staircase=True),
    "natural_exp": lambda s: s.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_staircase": lambda s: s.natural_exp_decay(0.1, 3, 0.5, True),
    "inverse_time": lambda s: s.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_staircase": lambda s: s.inverse_time_decay(0.1, 3, 0.5,
                                                             True),
    "polynomial": lambda s: s.polynomial_decay(0.1, 8, 0.001, power=2.0),
    "piecewise": lambda s: s.piecewise_decay([3, 7], [0.1, 0.05, 0.01]),
    "cosine": lambda s: s.cosine_decay(0.1, 2, 6),
    "linear_warmup": lambda s: s.linear_lr_warmup(0.1, 5, 0.0, 0.1),
    "warmup_into_polynomial": lambda s: s.linear_lr_warmup(
        s.polynomial_decay(0.1, 10, 0.0, 1.0), 4, 0.0, 0.1),
}


def _schedule(mod, names, which):
    main, startup = mod.Program(), mod.Program()
    with names.guard(), mod.program_guard(main, startup):
        lr = SCHEDULES[which](mod.layers.learning_rate_scheduler)
    return main, startup, lr


@pytest.mark.parametrize("which", sorted(SCHEDULES))
def test_schedule_matches_the_jax_package(which):
    jmain, jstartup, jlr = _schedule(fluid, jax_names, which)
    tmain, tstartup, tlr = _schedule(pt, torch_names, which)
    for j, t in ((jmain, tmain), (jstartup, tstartup)):
        assert [op.desc() for op in t.global_block().ops] == \
            [op.desc() for op in j.global_block().ops]
    jexe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        jexe.run(jstartup)
        want = [float(np.asarray(jexe.run(jmain, fetch_list=[jlr.name])[0])
                      .reshape(-1)[0]) for _ in range(12)]
    texe, tscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    got = [float(texe.run(tmain, fetch_list=[tlr.name], scope=tscope)[0]
                 .reshape(-1)[0]) for _ in range(12)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    assert len(set(got)) > 1


def test_the_port_has_every_schedule():
    sched = pt.layers.learning_rate_scheduler
    assert sorted(sched.__all__) == sorted(
        fluid.layers.learning_rate_scheduler.__all__)
    assert len(sched.__all__) == 8 and callable(sched._floor)


# -- l2_normalize -------------------------------------------------------------------


@pytest.mark.parametrize("form", ["layers", "nn"])
def test_l2_normalize_matches_the_jax_package(form):
    x = f32(3, 5)

    def build(mod, names):
        main = mod.Program()
        with names.guard(), mod.program_guard(main, mod.Program()):
            xv = mod.data("x", shape=[-1, 5])
            fn = mod.layers.l2_normalize if form == "layers" else \
                mod.layers.nn.l2_normalize
            out = fn(xv, axis=1)
        return main, out

    jmain, jout = build(fluid, jax_names)
    tmain, tout = build(pt, torch_names)
    assert [op.desc() for op in tmain.global_block().ops] == \
        [op.desc() for op in jmain.global_block().ops]
    with fluid.scope_guard(fluid.Scope()):
        want = np.asarray(fluid.Executor(fluid.CPUPlace()).run(
            jmain, feed={"x": x}, fetch_list=[jout.name])[0])
    got = pt.Executor(pt.CPUPlace()).run(tmain, feed={"x": x},
                                         fetch_list=[tout.name],
                                         scope=pt.Scope())[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
