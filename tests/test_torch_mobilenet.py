"""MobileNet V1/V2 in the PyTorch port against the JAX package, on the CPU.

* Both packages' ``build_mobilenet_train(version=1|2)`` at ImageNet
  width (3x224x224, 1000 classes) emit the same ops (types, attributes,
  var names, in order), the same startup ops, the same vars and
  parameters: a build, no run.
* V1 and V2 at ``class_dim=10``, batch 2 (the batch of
  ``tests/test_models.py``), momentum 0.9 at lr 0.01: every persistable
  of the JAX startup carries into the port by name. The JAX program runs
  3 steps; before each, the port loads the JAX state of that moment and
  runs the same step, so every step is held on its own.
  At the JAX test's 32x32 the last stages are 1x1 planes, where each
  batch norm normalises 2 values: two values within rounding of each
  other come out scaled up by up to ``1 / (2 sqrt(eps))`` = 158, and
  four such layers in a row scale a float32 rounding difference at the
  first convolution (1e-7) up to the loss (measured: 1.4e-2 relative for
  V1, 2.0e-1 for V2, the same in either package against a float64 run
  of the port). At 64x64 the last stages are 2x2 planes (8 values a
  norm), and the steps are held there:
  - the loss within ``LOSS_RTOL`` (measured: V1 5.9e-6, V2 3.0e-5);
  - all grads together in norm within ``GRAD_NORM_TOL`` (measured:
    9.1e-5 to 2.2e-4 in the first two steps, 1.6e-2 (V1) and 2.2e-3
    (V2) in the third, where the 2x2 planes' norms amplify too), each
    grad within ``GRAD_TOL`` of its largest value or of 1e-2 of the
    largest grad, whichever is larger (measured: at most 1.0e-3 in the
    first two steps, 0.24 in V1's third). The floor: the bias of a batch
    norm whose output feeds a convolution and then a batch norm has a
    true grad of 0, and both packages give it rounding noise of 1e-7;
  - each parameter, velocity and moving statistic likewise, against its
    update (``STATE_TOL``; measured at most 0.22).
  A wrong lowering moves these by 1 or more.
* At the JAX test's 32x32, ``FLOAT64_RATIO``: the JAX float32 loss stands
  no farther from the port's float64 loss than that many times the
  port's own float32 loss does (measured: 5.4e-2 against 2.0e-2 for V1,
  9.3e-1 against 3.8e-1 for V2, ratios 2.6 and 2.4).
* Inference through the port's predictor: a small depthwise-separable
  net (the JAX package's ``test_predictor_convnet_batchnorm``) trains 5
  steps, is saved with ``save_inference_model``, and the predictor (whose
  ``conv_bn_fuse`` folds every batch norm into its grouped or pointwise
  convolution) agrees with the ``for_test`` clone within
  ``PREDICTOR_TOL`` and bit for bit across two calls.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models import mobilenet as jax_mobilenet
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch import inference
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.models import mobilenet as torch_mobilenet
from paddle_tpu_torch.utils import unique_name as torch_names

LR, BATCH, STEPS = 0.01, 2, 3
LOSS_RTOL = 1e-4
GRAD_NORM_TOL = 5e-2
GRAD_TOL = 0.5           # of max(its largest value, FLOOR x the largest grad)
STATE_TOL = 0.5          # of max(its update, FLOOR x the largest update)
FLOOR = 1e-2
FLOAT64_RATIO = 10.0
PREDICTOR_TOL = (1e-5, 1e-6)


def _build(mod, names, **kw):
    with names.guard():
        return mod.build_mobilenet_train(**kw)


@pytest.mark.parametrize("version", [1, 2])
def test_imagenet_programs_match_the_jax_builder(version):
    want = _build(jax_mobilenet, jax_names, version=version)
    got = _build(torch_mobilenet, torch_names, version=version)
    for program in (0, 1):
        wb, gb = want[program].global_block(), got[program].global_block()
        assert [op.desc() for op in gb.ops] == [op.desc() for op in wb.ops]
        # the JAX package runs top_k's indices as int32 (64-bit types off)
        wv = [v.desc() for v in wb.vars.values()]
        for v, g in zip(wv, gb.vars.values()):
            if v["dtype"] == "int32" and g.dtype == "int64":
                v["dtype"] = "int64"
        assert [v.desc() for v in gb.vars.values()] == wv
    assert [p.name for p in got[0].all_parameters()] == [
        p.name for p in want[0].all_parameters()]
    ops = [op.type for op in got[0].global_block().ops]
    depthwise = [op for op in got[0].global_block().ops
                 if op.type == "conv2d" and op.attrs["groups"] > 1]
    assert ops.count("adaptive_pool2d") == 1 and ops.count("flatten2") == 1
    assert len(depthwise) == (13 if version == 1 else 17)
    trainable = [p for p in got[0].all_parameters() if p.trainable]
    n = sum(int(np.prod(p.shape)) for p in trainable)
    # 4.23M weights (V1) and 3.50M (V2) with a 1000-way fc
    assert (4_200_000 < n < 4_260_000) if version == 1 else (
        3_480_000 < n < 3_520_000)


def _feed(hw):
    rng = np.random.RandomState(0)
    return {"img": rng.randn(BATCH, 3, hw, hw).astype(np.float32),
            "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}


def _runs(version, hw):
    small = dict(version=version, class_dim=10, lr=LR, image_shape=(3, hw, hw))
    jmain, jstartup, _, jfetch = _build(jax_mobilenet, jax_names, **small)
    tmain, tstartup, _, tfetch = _build(torch_mobilenet, torch_names, **small)
    feed = _feed(hw)
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
    return dict(states=states, loaded=loaded, params=params, jrun=jrun,
                trun=trun, tstates=tstates, main=tmain, feed=feed,
                fetch=fetch)


@pytest.fixture(scope="module", params=[1, 2], ids=["v1", "v2"])
def runs(request):
    return _runs(request.param, 64)


def test_jax_startup_state_carries_over_by_name(runs):
    names = set(runs["states"][0])
    assert names == runs["loaded"]
    assert {"conv1_w", "fc_0.w_0", "fc_0.w_0_velocity_0"} <= names


def _floored_errors(got, want, scale):
    """{name: max |got - want| / max(scale[name], FLOOR x max(scale))}."""
    floor = FLOOR * max(scale.values())
    return {n: float(np.abs(got[n] - w).max()) / max(scale[n], floor)
            for n, w in want.items()}


@pytest.mark.parametrize("step", range(STEPS))
def test_each_step_matches_jax(runs, step):
    want, got = runs["jrun"][step], runs["trun"][step]
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got[1], want[1])
    params = runs["params"]
    gw = dict(zip(params, want[2:]))
    gg = dict(zip(params, got[2:]))
    norm = np.sqrt(sum(np.sum((gg[n] - gw[n]) ** 2) for n in params)
                   / sum(np.sum(gw[n] ** 2) for n in params))
    assert norm <= GRAD_NORM_TOL, norm
    errs = _floored_errors(gg, gw, {n: float(np.abs(w).max())
                                    for n, w in gw.items()})
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("step", range(STEPS))
def test_each_steps_state_matches_jax(runs, step):
    before, want = runs["states"][step], runs["states"][step + 1]
    got = runs["tstates"][step]
    assert set(got) == set(want)
    moved = {n: float(np.abs(w - before[n]).max()) for n, w in want.items()}
    errs = _floored_errors(got, want, moved)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STATE_TOL, (worst, errs[worst])


@pytest.mark.parametrize("version", [1, 2])
def test_the_jax_test_size_is_float32_noise_in_both_packages(version):
    """At the JAX test's 32x32, one step from the JAX startup: the two
    packages' float32 losses part (the 1x1 planes' batch norms scale the
    rounding up), but the JAX package's stands no farther from the port's
    float64 loss than ``FLOAT64_RATIO`` times the port's own float32
    loss does."""
    small = dict(version=version, class_dim=10, lr=LR, image_shape=(3, 32, 32))
    jmain, jstartup, _, (jloss, _) = _build(jax_mobilenet, jax_names, **small)
    tmain, tstartup, _, (tloss, _) = _build(torch_mobilenet, torch_names,
                                            **small)
    feed = _feed(32)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.asarray(jscope.find_var(v.name))
                 for v in jmain.global_block().vars.values() if v.persistable}
        (want,) = jexe.run(jmain, feed=feed, fetch_list=[jloss.name])
    losses = {}
    for dtype in (np.float32, np.float64):
        exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
        for name, a in state.items():
            a = np.asarray(a)
            scope.set(name, torch.from_numpy(
                a.astype(dtype) if a.dtype.kind == "f" else a.copy()))
        (losses[dtype],) = exe.run(
            tmain, feed={k: torch.from_numpy(v.astype(dtype) if v.dtype.kind
                                             == "f" else v)
                         for k, v in feed.items()},
            fetch_list=[tloss.name], scope=scope)
    truth = float(losses[np.float64][0])
    port = abs(float(losses[np.float32][0]) - truth)
    jax = abs(float(want[0]) - truth)
    assert np.isfinite([truth, port, jax]).all()
    assert jax <= FLOAT64_RATIO * port + 1e-6 * abs(truth), (jax, port, truth)


def test_predictor_folds_grouped_convs_and_matches_the_clone(tmp_path):
    """The JAX package's ``test_predictor_convnet_batchnorm`` in the
    port: MobileNet's blocks, 5 training steps, ``save_inference_model``,
    the predictor's ``conv_bn_fuse`` over the grouped and pointwise
    convolutions, against the ``for_test`` clone; bit-equal across two
    calls."""
    rng = np.random.RandomState(1234)
    main, startup = pt.Program(), pt.Program()
    with torch_names.guard(), pt.program_guard(main, startup):
        img = pt.data("img", [-1, 3, 16, 16])
        lab = pt.data("lab", [-1, 1], dtype="int64")
        h = torch_mobilenet._conv_bn(img, 8, 3, stride=2, name="p0")
        h = torch_mobilenet._depthwise_separable(h, 16, 2, name="p1")
        h = pt.layers.adaptive_pool2d(h, 1, pool_type="avg")
        prob = pt.layers.fc(pt.layers.flatten(h), size=4, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(prob, lab))
        pt.optimizer.MomentumOptimizer(0.01, 0.9).minimize(loss)
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(5):
        exe.run(main, feed={
            "img": rng.randn(4, 3, 16, 16).astype("float32"),
            "lab": rng.randint(0, 4, (4, 1)).astype("int64"),
        }, fetch_list=[loss], scope=scope)
    model_dir = str(tmp_path / "convmodel")
    with pt.scope_guard(scope):
        pt.io.save_inference_model(model_dir, ["img"], [prob], exe,
                                   main_program=main)
    infer = main.clone(for_test=True)
    xq = rng.randn(2, 3, 16, 16).astype("float32")
    (ref,) = exe.run(infer, feed={"img": xq, "lab": np.zeros((2, 1), "int64")},
                     fetch_list=[prob], scope=scope)
    config = inference.Config(model_dir)
    config.disable_gpu()
    predictor = inference.create_predictor(config)
    assert predictor.analysis_stats()["conv_bn_fuse"]["fused"] == 3
    types = [op.type for op in predictor._program.global_block().ops]
    assert "batch_norm" not in types
    out = predictor.run([xq])[0]
    rtol, atol = PREDICTOR_TOL
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(predictor.run([xq])[0], out)
