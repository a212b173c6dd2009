"""ResNet in the PyTorch port against the JAX package, on the CPU.

* Both packages' ``build_resnet_train(depth=50)`` (ImageNet widths)
  emit the same ops (types, attributes, var names, in order), the same
  startup ops, and the same vars and parameters: a build, no run.
* ResNet-18 at ``image_shape=(3, 32, 32)``, ``class_dim=10``, batch 4
  (the size of ``tests/test_models.py``), momentum 0.9 with
  ``L2Decay(1e-4)`` at lr 0.01: every persistable of the JAX startup
  (conv weights, BN scales and offsets, moving means and variances,
  velocities, the learning rate) carries into the port by name. The JAX
  program runs 3 steps; before each, the port loads the JAX state of that
  moment and runs the same step, so every step is held on its own:
  - the loss within rtol 1e-5 (measured: 1.8e-6), accuracy exactly;
  - every ``param@GRAD`` and every velocity within 1e-3 of its own
    largest value (measured: 1.1e-4);
  - every parameter within 2e-3 of its update's largest value
    (measured: 3.9e-4; the BN scales, whose updates are the smallest);
  - both BN moving statistics within 1e-4 of their largest value
    (measured: 6.2e-6).
  Steps are held one at a time because this configuration amplifies
  float32 rounding: the BN layers of its last stage normalise 4 values
  each (batch 4 of 1x1 planes) and its ReLUs flip where an input lies
  within rounding of 0, so two free-running streams that differ only in
  the order of their float32 sums part within a few steps. The port's
  own 3 free-running steps must still lower the loss.
* ``build_resnet_infer`` (``clone(for_test=True)``, BN on the moving
  statistics) in both packages on the state after the 3 steps: the
  softmax within rtol 1e-4, atol 1e-6, and every row sums to 1.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.models import resnet as torch_resnet
from paddle_tpu_torch.utils import unique_name as torch_names

SMALL = dict(depth=18, class_dim=10, image_shape=(3, 32, 32))
LR, BATCH, STEPS = 0.01, 4, 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3        # of each grad's (velocity's) own largest value
PARAM_TOL = 2e-3       # of each parameter's update's largest value
STAT_TOL = 1e-4        # of each moving statistic's largest value
PROB_TOL = (1e-4, 1e-6)


def _build(mod, names, **kw):
    with names.guard():
        return mod.build_resnet_train(**kw)


@pytest.fixture(scope="module")
def resnet50():
    return (_build(jax_resnet, jax_names, depth=50),
            _build(torch_resnet, torch_names, depth=50))


@pytest.mark.parametrize("program", [0, 1], ids=["main", "startup"])
def test_resnet50_programs_match_the_jax_builder(resnet50, program):
    want = resnet50[0][program].global_block()
    got = resnet50[1][program].global_block()
    assert [op.desc() for op in got.ops] == [op.desc() for op in want.ops]
    # the JAX package runs int64 index vars as int32 (64-bit types off);
    # the port keeps top_k's indices int64, its torch index type
    indices = {n for op in got.ops if op.type == "top_k"
               for n in op.output("Indices")}
    wv = [v.desc() for v in want.vars.values()]
    for v in wv:
        if v["name"] in indices:
            v["dtype"] = "int64"
    assert [v.desc() for v in got.vars.values()] == wv
    if program == 0:
        assert [p.name for p in got.all_parameters()] == [
            p.name for p in want.program.all_parameters()]


def test_resnet50_shape(resnet50):
    main = resnet50[1][0]
    ops = [op.type for op in main.global_block().ops]
    assert ops.count("conv2d") == 53 and ops.count("batch_norm") == 53
    trainable = [p for p in main.all_parameters() if p.trainable]
    assert len(trainable) == 161
    # 25.56M weights (ResNet-50 with a 1000-way fc)
    n = sum(int(np.prod(p.shape)) for p in trainable)
    assert 25_500_000 < n < 25_600_000
    # every trainable parameter gets L2 decay (scale + sum) and a momentum
    assert ops.count("momentum") == 161 and ops.count("scale") >= 161


def test_amp_raises_naming_m1b():
    with pytest.raises(NotImplementedError, match="M1b"):
        torch_resnet.build_resnet_train(use_amp=True, **SMALL)


@pytest.fixture(scope="module")
def runs():
    jmain, jstartup, _, jfetch = _build(jax_resnet, jax_names, lr=LR, **SMALL)
    tmain, tstartup, _, tfetch = _build(torch_resnet, torch_names, lr=LR,
                                        **SMALL)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(BATCH, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}
    params = [p.name for p in tmain.all_parameters() if p.trainable]
    fetch = [tfetch[0].name, tfetch[1].name] + [p + "@GRAD" for p in params]

    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = [v.name for v in jmain.global_block().vars.values()
             if v.persistable]
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        states = [{n: np.asarray(jscope.find_var(n)) for n in names
                   if jscope.find_var(n) is not None}]
        jrun = []
        for _ in range(STEPS):
            jrun.append(jexe.run(jmain, feed=feed, fetch_list=fetch))
            states.append({n: np.asarray(jscope.find_var(n))
                           for n in states[0]})

    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    loaded = set(persistables_to_numpy(tscope, tmain))
    trun, tstates = [], []
    for k in range(STEPS):
        load_params(tscope, states[k])
        trun.append(texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope))
        tstates.append(persistables_to_numpy(tscope, tmain))
    free = [float(texe.run(tmain, feed=feed, fetch_list=[tfetch[0].name],
                           scope=tscope)[0][0]) for _ in range(STEPS)]
    return dict(states=states, loaded=loaded, params=params, jrun=jrun,
                trun=trun, tstates=tstates, free=free, feed=feed)


def test_jax_startup_state_carries_over_by_name(runs):
    names = set(runs["states"][0])
    assert names == runs["loaded"]
    assert {"res_conv1_weights", "res_conv1_bn_mean",
            "res5b_branch2b_bn_variance", "fc_0.w_velocity_0"} <= names


@pytest.mark.parametrize("step", range(STEPS))
def test_each_step_matches_jax(runs, step):
    want, got = runs["jrun"][step], runs["trun"][step]
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got[1], want[1])
    for name, g, w in zip(runs["params"], got[2:], want[2:]):
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("step", range(STEPS))
def test_each_steps_state_matches_jax(runs, step):
    before, want = runs["states"][step], runs["states"][step + 1]
    got = runs["tstates"][step]
    assert set(got) == set(want)
    params = set(runs["params"])
    for name, w in want.items():
        err = np.abs(got[name] - w).max()
        if name in params:
            bar = PARAM_TOL * np.abs(w - before[name]).max()
        elif name.endswith(("_bn_mean", "_bn_variance")):
            bar = STAT_TOL * np.abs(w).max()
        else:                               # velocities, the learning rate
            bar = GRAD_TOL * np.abs(w).max()
        assert err <= bar, (name, err, bar)
        if name.endswith(("_bn_mean", "_bn_variance")):
            assert not np.array_equal(w, before[name]), name


def test_free_running_steps_lower_the_loss(runs):
    free = runs["free"]
    assert np.isfinite(free).all() and free[-1] < free[0]


def test_infer_clone_matches_jax_after_the_steps(runs):
    state = runs["states"][-1]
    with jax_names.guard():
        jinfer, _, _, (jprob,) = jax_resnet.build_resnet_infer(**SMALL)
    with torch_names.guard():
        tinfer, _, _, (tprob,) = torch_resnet.build_resnet_infer(**SMALL)
    bn = [op for op in tinfer.global_block().ops if op.type == "batch_norm"]
    assert bn and all(op.attrs["is_test"] for op in bn)
    feed = {"img": runs["feed"]["img"]}
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    for name in tinfer.global_block().vars:
        if name in state:
            jscope.set(name, state[name])
    with fluid.scope_guard(jscope):
        (want,) = jexe.run(jinfer, feed=feed, fetch_list=[jprob.name])
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    for name, v in tinfer.global_block().vars.items():
        if v.persistable:
            tscope.set(name, torch.tensor(state[name]))
    (got,) = texe.run(tinfer, feed=feed, fetch_list=[tprob.name], scope=tscope)
    rtol, atol = PROB_TOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
