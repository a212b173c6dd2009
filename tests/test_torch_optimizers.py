"""The optimizer surface of the PyTorch port (M1b) against the JAX package,
on the CPU at small sizes:

* each of the 12 update ops (``adamw``, ``adagrad``, ``rmsprop``,
  ``adamax``, ``adadelta``, ``decayed_adagrad``, ``ftrl``, ``lamb``,
  ``lars_momentum``, ``dpsgd``, ``ema_update``, ``model_average_update``)
  against the JAX lowering on the same numpy inputs, and their branches:
  ``lamb``'s and ``lars_momentum``'s trust ratio at a zero norm, ``dpsgd``
  over and under its clip (its noise is ``jax.random.normal`` at the op's
  key, ``PRNGKey(0)`` here, in both), ``model_average_update`` at its
  window cap, centred ``rmsprop``, ``ftrl`` with l1/l2. Floats within
  rtol 1e-5, atol 1e-6 (``tests/test_torch_train_ops.py``'s bar: float32
  sums and ``pow`` in another order);
* each optimizer class builds the same main and startup programs as the
  JAX class (op types, names, attrs, in order) on a small net, and 3
  steps from the JAX startup's state agree: losses within rtol 1e-5, every
  persistable within rtol 1e-5, atol 1e-6 (``ExponentialMovingAverage``
  and ``ModelAverage`` with their ``apply`` too);
* training state carries across: LAMB's moments and beta powers, the EMA
  shadows and ModelAverage's sums saved by the JAX package's
  ``io.save_persistables`` load into the port by name
  (``io.load_persistables``), and the next step matches the JAX
  package's next step at the same bars.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.utils import unique_name as torch_names

from test_torch_train_ops import _assert_same, _run_jax, _run_torch

R = np.random.RandomState(24)


def f32(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def pos(*shape):
    return (np.abs(R.randn(*shape)) * 0.1 + 0.01).astype(np.float32)


def one(v):
    return np.array([v], np.float32)


_P, _G = f32(4, 3), f32(4, 3)
_LR = one(1e-2)
_ADAM = {"Param": [_P], "Grad": [_G], "Moment1": [f32(4, 3, scale=0.1)],
         "Moment2": [pos(4, 3)], "Beta1Pow": [one(0.9 ** 3)],
         "Beta2Pow": [one(0.999 ** 3)], "LearningRate": [_LR]}

# op type -> (inputs, attrs): the 12 update ops of M1b
CASES = {
    "adamw": (_ADAM, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                      "coeff": 0.01}),
    "adagrad": ({"Param": [_P], "Grad": [_G], "Moment": [pos(4, 3)],
                 "LearningRate": [_LR]}, {"epsilon": 1e-6}),
    "rmsprop": ({"Param": [_P], "Grad": [_G], "Moment": [f32(4, 3, scale=.1)],
                 "MeanSquare": [pos(4, 3)], "MeanGrad": [f32(4, 3, scale=.01)],
                 "LearningRate": [_LR]},
                {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9,
                 "centered": False}),
    "adamax": ({"Param": [_P], "Grad": [_G], "Moment": [f32(4, 3, scale=.1)],
                "InfNorm": [pos(4, 3)], "Beta1Pow": [one(0.9 ** 2)],
                "LearningRate": [_LR]},
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adadelta": ({"Param": [_P], "Grad": [_G], "AvgSquaredGrad": [pos(4, 3)],
                  "AvgSquaredUpdate": [pos(4, 3)]},
                 {"epsilon": 1e-6, "rho": 0.95}),
    "decayed_adagrad": ({"Param": [_P], "Grad": [_G], "Moment": [pos(4, 3)],
                         "LearningRate": [_LR]},
                        {"decay": 0.95, "epsilon": 1e-6}),
    "ftrl": ({"Param": [_P], "Grad": [_G], "SquaredAccumulator": [pos(4, 3)],
              "LinearAccumulator": [f32(4, 3, scale=0.1)],
              "LearningRate": [_LR]},
             {"l1": 0.0, "l2": 0.0, "lr_power": -0.5}),
    "lamb": (_ADAM, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                     "weight_decay": 0.01}),
    "lars_momentum": ({"Param": [_P], "Grad": [_G],
                       "Velocity": [f32(4, 3, scale=0.1)],
                       "LearningRate": [_LR]},
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005, "epsilon": 0.0}),
    "dpsgd": ({"Param": [_P], "Grad": [_G], "LearningRate": [_LR]},
              {"clip": 10.0, "batch_size": 16.0, "sigma": 1.0}),
    "ema_update": ({"Param": [_P], "Shadow": [f32(4, 3)]}, {"decay": 0.9}),
    "model_average_update": ({"Param": [_P], "Sum": [f32(4, 3)],
                              "Count": [np.array([3.0, 7.0], np.float32)]},
                             {"rate": 0.15, "min_window": 2.0,
                              "max_window": 10.0}),
}

_ZERO = np.zeros((4, 3), np.float32)


def _with(op, **slots):
    ins, attrs = CASES[op]
    return dict(ins, **{k: [v] for k, v in slots.items()}), attrs


# the branches the JAX lowerings take on their data
BRANCHES = {
    "lamb_zero_param": ("lamb", *_with("lamb", Param=_ZERO)),
    "lamb_zero_update": ("lamb", *_with("lamb", Param=_ZERO, Grad=_ZERO,
                                        Moment1=_ZERO)),
    "lars_zero_grad": ("lars_momentum", *_with("lars_momentum", Grad=_ZERO)),
    "lars_zero_param": ("lars_momentum", *_with("lars_momentum",
                                                Param=_ZERO)),
    "dpsgd_over_clip": ("dpsgd", CASES["dpsgd"][0],
                        dict(CASES["dpsgd"][1], clip=0.5)),
    "model_average_at_cap": ("model_average_update", *_with(
        "model_average_update", Count=np.array([10.0, 80.0], np.float32))),
    "model_average_first": ("model_average_update", *_with(
        "model_average_update", Sum=_ZERO,
        Count=np.array([0.0, 0.0], np.float32))),
    "rmsprop_centered": ("rmsprop", CASES["rmsprop"][0],
                         dict(CASES["rmsprop"][1], centered=True)),
    "ftrl_l1_l2": ("ftrl", CASES["ftrl"][0],
                   dict(CASES["ftrl"][1], l1=0.05, l2=0.1, lr_power=-0.6)),
}


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_update_op_matches_jax_lowering(op_type):
    ins, attrs = CASES[op_type]
    got = _run_torch(op_type, ins, attrs)
    _assert_same(got, _run_jax(op_type, ins, attrs))
    assert not np.array_equal(next(iter(got.values()))[0],
                              next(iter(ins.values()))[0])


@pytest.mark.parametrize("case", sorted(BRANCHES))
def test_update_op_branch_matches_jax_lowering(case):
    op_type, ins, attrs = BRANCHES[case]
    _assert_same(_run_torch(op_type, ins, attrs),
                 _run_jax(op_type, ins, attrs))


def test_dpsgd_clips_and_adds_the_jax_noise():
    """Under its clip the grad is kept as it is; over it, scaled to the
    clip; the noise is ``sigma * clip * normal / batch_size``."""
    ins, attrs = CASES["dpsgd"]
    zero_lr = dict(ins, LearningRate=[one(1.0)], Param=[_ZERO])
    for clip in (10.0, 0.5):
        a = dict(attrs, clip=clip)
        got = _run_torch("dpsgd", zero_lr, a)["ParamOut"][0]
        norm = np.sqrt(np.sum(_G.astype(np.float64) ** 2))
        g = _G * (clip / norm) if norm > clip else _G
        noise = -(got + g)
        # the noise's scale: sigma * clip / batch_size
        assert abs(noise.std() / (clip / 16.0) - 1.0) < 0.6, clip
        np.testing.assert_allclose(
            got, _run_jax("dpsgd", zero_lr, a)["ParamOut"][0], rtol=1e-5,
            atol=1e-6)


# -- the classes -----------------------------------------------------------------

CLASSES = {
    "LarsMomentum": lambda m: m.optimizer.LarsMomentum(0.1, 0.9),
    "Adagrad": lambda m: m.optimizer.Adagrad(0.1, initial_accumulator_value=0.1),
    "AdamW": lambda m: m.optimizer.AdamW(0.01, weight_decay=0.05),
    "Lamb": lambda m: m.optimizer.Lamb(
        0.01, exclude_from_weight_decay_fn=lambda p: p.name.endswith(".b_0")),
    "Adamax": lambda m: m.optimizer.Adamax(0.01),
    "Adadelta": lambda m: m.optimizer.Adadelta(1.0),
    "DecayedAdagrad": lambda m: m.optimizer.DecayedAdagrad(0.1),
    "RMSProp": lambda m: m.optimizer.RMSProp(0.01, momentum=0.5),
    "RMSPropCentered": lambda m: m.optimizer.RMSProp(0.01, centered=True),
    "Ftrl": lambda m: m.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    "Dpsgd": lambda m: m.optimizer.Dpsgd(0.05, clip=1.0, batch_size=8.0,
                                         sigma=0.5),
    "ExponentialMovingAverage": lambda m: m.optimizer.Momentum(0.1, 0.9),
    "ModelAverage": lambda m: m.optimizer.SGD(0.1),
}
STEPS = 3


def _net(mod, names, which, seed=3):
    main, startup = mod.Program(), mod.Program()
    main.random_seed = startup.random_seed = seed
    extra = None
    with names.guard(), mod.program_guard(main, startup):
        x = mod.data("x", shape=[-1, 6])
        y = mod.data("y", shape=[-1, 1])
        h = mod.layers.fc(x, size=5, act="relu")
        pred = mod.layers.fc(h, size=1)
        loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
        CLASSES[which](mod).minimize(loss)
        if which == "ExponentialMovingAverage":
            extra = mod.optimizer.ExponentialMovingAverage(0.9)
            extra.update()
        elif which == "ModelAverage":
            extra = mod.optimizer.ModelAverage(0.5, min_average_window=1,
                                               max_average_window=2)
            extra.minimize_after()
    return main, startup, loss, extra


def _feed():
    rng = np.random.RandomState(7)
    x = rng.randn(8, 6).astype(np.float32)
    return {"x": x, "y": x.sum(1, keepdims=True).astype(np.float32)}


def _jax_state(scope, main):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _descs(block):
    return [op.desc() for op in block.ops]


@pytest.mark.parametrize("which", sorted(CLASSES))
def test_optimizer_class_matches_the_jax_class(which):
    jmain, jstartup, jloss, jextra = _net(fluid, jax_names, which)
    tmain, tstartup, tloss, textra = _net(pt, torch_names, which)
    for j, t in ((jmain, tmain), (jstartup, tstartup)):
        assert _descs(t.global_block()) == _descs(j.global_block())
    feed = _feed()
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = _jax_state(jscope, jmain)
        jl = [float(np.asarray(jexe.run(jmain, feed=feed,
                                        fetch_list=[jloss])[0]).reshape(-1)[0])
              for _ in range(STEPS)]
        japplied = None
        if jextra is not None:
            with jextra.apply():
                japplied = _jax_state(jscope, jmain)
    jstate = _jax_state(jscope, jmain)
    texe, tscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    load_params(tscope, state)
    tl = [float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                         scope=tscope)[0].reshape(-1)[0])
          for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    tstate = persistables_to_numpy(tscope, tmain)
    assert set(tstate) == set(jstate)
    for name, want in jstate.items():
        np.testing.assert_allclose(tstate[name], want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    moved = [n for n in state if not np.array_equal(jstate[n], state[n])]
    assert len(moved) >= 4
    if textra is not None:
        with pt.scope_guard(tscope):
            with textra.apply():
                tapplied = persistables_to_numpy(tscope, tmain)
            restored = persistables_to_numpy(tscope, tmain)
        for name, want in japplied.items():
            np.testing.assert_allclose(tapplied[name], want, rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_array_equal(restored[name], tstate[name])
        # apply swapped something in
        assert any(not np.array_equal(tapplied[n], tstate[n])
                   for n in tstate)


def test_state_saved_by_the_jax_package_carries_into_the_port(tmp_path):
    """LAMB's moments and beta powers, EMA's shadows and ModelAverage's
    sums, written by the JAX package's ``io.save_persistables``, load into
    the port by name; the next step matches the JAX package's."""

    def build(mod, names):
        main, startup = mod.Program(), mod.Program()
        main.random_seed = startup.random_seed = 3
        with names.guard(), mod.program_guard(main, startup):
            x = mod.data("x", shape=[-1, 6])
            y = mod.data("y", shape=[-1, 1])
            pred = mod.layers.fc(mod.layers.fc(x, size=5, act="relu"), size=1)
            loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
            mod.optimizer.Lamb(0.01).minimize(loss)
            mod.optimizer.ExponentialMovingAverage(0.9).update()
            mod.optimizer.ModelAverage(0.5, 1, 3).minimize_after()
        return main, startup, loss

    feed = _feed()
    jmain, jstartup, jloss = build(fluid, jax_names)
    tmain, tstartup, tloss = build(pt, torch_names)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        for _ in range(2):
            jexe.run(jmain, feed=feed, fetch_list=[jloss])
        fluid.io.save_persistables(jexe, str(tmp_path), jmain)
        saved = _jax_state(jscope, jmain)
        jnext = jexe.run(jmain, feed=feed, fetch_list=[jloss])[0]
    jstate = _jax_state(jscope, jmain)
    kinds = {"moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc", "ema_",
             "model_avg_sum_", "model_avg_cnt_"}
    assert all(any(k in n for n in saved) for k in kinds)

    texe, tscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    with pt.scope_guard(tscope):
        pt.io.load_persistables(texe, str(tmp_path), tmain)
    loaded = persistables_to_numpy(tscope, tmain)
    assert set(loaded) == set(saved)
    for name, want in saved.items():
        np.testing.assert_array_equal(loaded[name], want, err_msg=name)
    tnext = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)[0]
    np.testing.assert_allclose(tnext, np.asarray(jnext), rtol=1e-5)
    tstate = persistables_to_numpy(tscope, tmain)
    for name, want in jstate.items():
        np.testing.assert_allclose(tstate[name], want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_pipeline_optimizer_raises_naming_m11():
    with pytest.raises(NotImplementedError, match="M11"):
        pt.optimizer.PipelineOptimizer(pt.optimizer.SGD(0.1),
                                       num_microbatches=2)
