"""bf16 / float16 mixed precision in the PyTorch port against the JAX
package's ``amp`` (tests/test_amp.py's four cases, run through the port):

* ``decorate`` rewrites the program exactly as the JAX package does: the
  same ops in the same order with the same slots, cast names
  (``<var>.cast_<dtype>``) and attributes, and the same var dtypes, for
  bf16, and float16 with static and dynamic loss scaling;
* one AMP step computes every var in the same runtime dtype as the JAX
  step;
* from the JAX startup's weights (carried over by ``convert``), the AMP
  loss streams stay within a stated bar of JAX's. XLA fuses the jitted
  step and may keep a bf16 value in float32 where eager PyTorch rounds it
  (``xla_allow_excess_precision``), so the two are held to each other in
  structure exactly and in value within bars, never bit for bit;
* one step of a small conv net (ResNet's conv2d, batch_norm, residual
  add, pool and fc under momentum with L2 decay) gives every grad,
  velocity and update within a stated bar of JAX's, in bf16 and in
  float16 with static loss scaling;
* the dynamic loss-scaling state (scale, good and bad step counts) equals
  JAX's over a sequence with two overflow steps, and the ops
  ``check_finite_and_unscale`` / ``update_loss_scaling`` equal the JAX
  ops on the same inputs;
* a bf16 fetch comes back as float32 (numpy has no bfloat16), and the
  16-bit product guard puts the caller's cuBLAS settings back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import OpRegistry as JaxOps
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.core.registry import OpRegistry as TorchOps
from paddle_tpu_torch.ops.math import FLOAT32_REDUCTIONS
from paddle_tpu_torch.utils import unique_name as torch_names

# AMP against AMP, the same weights and feeds: the packages round the
# low type at other points (XLA's fused, jitted step may skip a round trip
# that eager torch makes), so over 20 SGD steps their loss streams part by
# 3.5e-4 relative in bf16 and 8.6e-6 in float16 (3 more mantissa bits) at
# most; the bars leave about ten times that, far below the gap between a
# bf16 and a float32 run (the JAX test's bar, 0.25 of the first loss).
AMP_LOSS_RTOL = {"bfloat16": 3e-3, "float16": 1e-4}


def _build(mod, names, with_amp, dest_dtype="bfloat16", loss_scaling=1.0,
           dynamic=False):
    """tests/test_amp.py's program (fc 16 -> 32 relu -> 4, softmax cross
    entropy, SGD 0.1) in package ``mod``."""
    with names.guard():
        main, startup = mod.Program(), mod.Program()
        main.random_seed = startup.random_seed = 5
        with mod.program_guard(main, startup):
            x = mod.data("x", shape=[-1, 16])
            y = mod.data("y", shape=[-1, 1], dtype="int64")
            h = mod.layers.fc(x, size=32, act="relu")
            logits = mod.layers.fc(h, size=4)
            loss = mod.layers.mean(
                mod.layers.softmax_with_cross_entropy(logits, y))
            opt = mod.optimizer.SGD(learning_rate=0.1)
            if with_amp:
                opt = mod.amp.decorate(
                    opt, init_loss_scaling=loss_scaling, dest_dtype=dest_dtype,
                    use_dynamic_loss_scaling=dynamic)
            opt.minimize(loss)
    return main, startup, loss, opt


def _regression(mod, names):
    """tests/test_amp.py's dynamic-scaling program: fc 8 -> 1, squared
    error, SGD 0.01, float16 with dynamic loss scaling from 2^15."""
    with names.guard():
        main, startup = mod.Program(), mod.Program()
        with mod.program_guard(main, startup):
            x = mod.data("x", shape=[-1, 8])
            y = mod.data("y", shape=[-1, 1])
            pred = mod.layers.fc(x, 1)
            loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
            opt = mod.amp.decorate(
                mod.optimizer.SGD(0.01), init_loss_scaling=2.0 ** 15,
                use_dynamic_loss_scaling=True, dest_dtype="float16")
            opt.minimize(loss)
    return main, startup, loss, opt


def _desc(program):
    """(ops, vars) of the global block, comparable across the packages:
    the JAX package runs int64 index vars as int32 (64-bit types off),
    the port keeps int64."""
    block = program.global_block()
    ops = [op.desc() for op in block.ops]
    vs = [v.desc() for v in block.vars.values()]
    for v in vs:
        if v["dtype"] == "int32" and not v["name"].startswith("loss_scaling"):
            v["dtype"] = "int64"
    return ops, vs


VARIANTS = {"bf16": dict(dest_dtype="bfloat16"),
            "f16_static": dict(dest_dtype="float16", loss_scaling=128.0),
            "f16_dynamic": dict(dest_dtype="float16", loss_scaling=2.0 ** 15,
                                dynamic=True)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_amp_rewrite_equals_the_jax_rewrite(variant):
    kw = VARIANTS[variant]
    want = _build(fluid, jax_names, True, **kw)[0]
    got = _build(pt, torch_names, True, **kw)[0]
    got_ops, got_vars = _desc(got)
    want_ops, want_vars = _desc(want)
    assert got_ops == want_ops
    assert got_vars == want_vars
    dt = kw["dest_dtype"]
    casts = [op for op in got.global_block().ops if op.type == "cast"]
    assert casts and all(op.attrs["out_dtype"] in (dt, "float32") for op in casts)
    # test_amp_inserts_casts: the fc products read the cast outputs
    muls = [op for op in got.global_block().ops if op.type == "mul"]
    assert len(muls) == 2 and all(
        n.endswith(f".cast_{dt}") for op in muls
        for n in op.input("X") + op.input("Y"))


def _jax_startup_state(main, startup):
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _train_jax(main, startup, loss, state, feeds, fetch=()):
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    out = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for name, a in state.items():
            scope.set(name, jnp.asarray(a))
        for feed in feeds:
            out.append(exe.run(main, feed=feed, fetch_list=[loss.name, *fetch]))
    return out, scope


def _train_port(main, startup, loss, state, feeds, fetch=()):
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, state)
    out = [exe.run(main, feed=feed, fetch_list=[loss.name, *fetch], scope=scope)
           for feed in feeds]
    return out, scope


def _learnable(rng, n=64):
    x = rng.rand(n, 16).astype("float32")
    w_true = rng.rand(16, 4)
    y = (x @ w_true).argmax(axis=1).astype("int64")[:, None]
    return {"x": x, "y": y}


@pytest.mark.parametrize("dest_dtype", ["bfloat16", "float16"])
def test_amp_trains_to_similar_loss_and_tracks_jax(dest_dtype):
    """test_amp_trains_to_similar_loss through the port, and the port's AMP
    loss stream against JAX's from the same startup weights."""
    feed = _learnable(np.random.RandomState(0))
    jmain, jstartup, jloss, _ = _build(fluid, jax_names, True, dest_dtype)
    state = _jax_startup_state(jmain, jstartup)
    tmain, tstartup, tloss, _ = _build(pt, torch_names, True, dest_dtype)
    fmain, fstartup, floss, _ = _build(pt, torch_names, False)
    steps = [feed] * 20
    amp = [float(r[0][0]) for r in _train_port(tmain, tstartup, tloss, state,
                                               steps)[0]]
    ref = [float(r[0][0]) for r in _train_port(fmain, fstartup, floss, state,
                                               steps)[0]]
    want = [float(r[0][0]) for r in _train_jax(jmain, jstartup, jloss, state,
                                               steps)[0]]
    assert amp[-1] < amp[0] * 0.8, "amp run did not converge"
    assert abs(ref[-1] - amp[-1]) < 0.25 * max(ref[0], 1e-3)
    np.testing.assert_allclose(amp, want, rtol=AMP_LOSS_RTOL[dest_dtype])


def test_fp16_loss_scaling_unscales():
    """float16 with static loss scaling 128 trains as with none."""
    rng = np.random.RandomState(1)
    feed = {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.randint(0, 4, (32, 1)).astype("int64")}
    jmain, jstartup, _, _ = _build(fluid, jax_names, True, "float16")
    state = _jax_startup_state(jmain, jstartup)

    def train(scaling):
        main, startup, loss, _ = _build(pt, torch_names, True, "float16",
                                        loss_scaling=scaling)
        return [float(r[0][0]) for r in _train_port(main, startup, loss, state,
                                                    [feed] * 10)[0]]

    a, b = train(1.0), train(128.0)
    np.testing.assert_allclose(a, b, rtol=0.05, atol=0.02)
    # and the scaled run tracks the JAX package's
    jmain, jstartup, jloss, _ = _build(fluid, jax_names, True, "float16",
                                       loss_scaling=128.0)
    want = [float(r[0][0]) for r in _train_jax(jmain, jstartup, jloss, state,
                                               [feed] * 10)[0]]
    np.testing.assert_allclose(b, want, rtol=AMP_LOSS_RTOL["float16"])


def _scaling_state(opt, get):
    names = (opt._scale_var.name, "loss_scaling_good_steps_0",
             "loss_scaling_bad_steps_0")
    return tuple(float(np.asarray(get(n)).reshape(-1)[0]) for n in names)


def test_dynamic_loss_scaling_recovers_from_overflow():
    """float16 with dynamic scaling: two overflowing steps in a row shrink
    the scale, the grads of an overflowing step are zeroed so the weights
    stay finite, and the scale and both step counts equal the JAX
    package's after every step of the sequence."""
    rng = np.random.RandomState(2)
    xs = rng.rand(16, 8).astype("float32")
    ys = rng.rand(16, 1).astype("float32")
    bad = np.full_like(xs, 1e4)
    feeds = [{"x": xs, "y": ys}] + [{"x": bad, "y": ys}] * 2 + \
        [{"x": xs, "y": ys}] * 2
    jmain, jstartup, jloss, jopt = _regression(fluid, jax_names)
    tmain, tstartup, tloss, topt = _regression(pt, torch_names)
    assert _desc(tmain) == _desc(jmain)
    state = _jax_startup_state(jmain, jstartup)
    assert {"loss_scaling_0", "loss_scaling_good_steps_0",
            "loss_scaling_bad_steps_0"} <= set(state)

    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
    texe.run(tstartup, scope=tscope)
    load_params(tscope, state)
    got, want = [], []
    for feed in feeds:
        with fluid.scope_guard(jscope):
            jexe.run(jmain, feed=feed, fetch_list=[jloss])
        out = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        want.append(_scaling_state(jopt, jscope.find_var))
        got.append(_scaling_state(topt, tscope.find_var))
        assert np.isfinite(out[0]).all() or feed["x"] is bad
    assert got == want
    scale0, scale1 = got[0][0], got[2][0]
    assert scale1 < scale0, (scale0, scale1)
    assert [g[1:] for g in got] == [(1, 0), (0, 1), (0, 0), (1, 0), (2, 0)]
    params = persistables_to_numpy(tscope, tmain)
    assert all(np.isfinite(a).all() for a in params.values())
    out = texe.run(tmain, feed=feeds[0], fetch_list=[tloss], scope=tscope)
    assert np.isfinite(out[0]).all()



def _conv_net(mod, names, dest_dtype, loss_scaling):
    """ResNet's pieces at a size where nothing amplifies a rounding gap:
    conv2d (no bias) -> batch_norm + relu, a second conv2d -> batch_norm
    added to the first block's output (one var, two consumers) -> relu,
    global average pool, fc, softmax cross entropy; momentum 0.9 with
    L2Decay(1e-4), as ``build_resnet_train`` trains."""
    with names.guard():
        main, startup = mod.Program(), mod.Program()
        main.random_seed = startup.random_seed = 7
        with mod.program_guard(main, startup):
            img = mod.data("img", shape=[-1, 3, 8, 8])
            label = mod.data("label", shape=[-1, 1], dtype="int64")
            h = mod.layers.conv2d(img, 8, 3, padding=1, bias_attr=False)
            h1 = mod.layers.batch_norm(h, act="relu")
            h = mod.layers.conv2d(h1, 8, 3, padding=1, bias_attr=False)
            h = mod.layers.elementwise_add(h1, mod.layers.batch_norm(h),
                                           act="relu")
            h = mod.layers.pool2d(h, global_pooling=True)
            loss = mod.layers.mean(mod.layers.softmax_with_cross_entropy(
                mod.layers.fc(h, 10), label))
            opt = mod.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9,
                regularization=mod.regularizer.L2Decay(1e-4))
            mod.amp.decorate(opt, init_loss_scaling=loss_scaling,
                             dest_dtype=dest_dtype).minimize(loss)
    return main, startup, loss


# one conv-net step from the same state, each value against JAX's within
# the bar x its largest magnitude. Measured: grads, velocities and updates
# 9.0e-3 in bf16 (the packages round a conv output at other points) and
# 6.6e-6 in float16; the decay term (velocity - grad from a zero velocity)
# 3.6e-5 and 6.6e-6. Zeroed grads, grads left scaled by 128, or a decay
# left out are 1.0 or more off.
CONV_NET = {"bf16": ("bfloat16", 1.0, 2e-2), "f16_static": ("float16", 128.0,
                                                            1e-4)}
CONV_NET_DECAY_TOL = 1e-3


@pytest.mark.parametrize("variant", sorted(CONV_NET))
def test_amp_conv_net_step_matches_jax(variant):
    """A bf16 / float16 conv-net step (bf16 conv2d and its grad, the cast
    grads into the float32 master weights, the unscale, L2 decay and
    momentum) against the JAX package's from the same state: every grad,
    velocity and parameter update within the bar, the decay term within
    CONV_NET_DECAY_TOL."""
    dest_dtype, scaling, tol = CONV_NET[variant]
    jmain, jstartup, jloss = _conv_net(fluid, jax_names, dest_dtype, scaling)
    tmain, tstartup, tloss = _conv_net(pt, torch_names, dest_dtype, scaling)
    assert _desc(tmain) == _desc(jmain)
    state = _jax_startup_state(jmain, jstartup)
    rng = np.random.RandomState(4)
    feed = {"img": rng.randn(8, 3, 8, 8).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}
    params = [p.name for p in tmain.all_parameters() if p.trainable]
    grads = [p + "@GRAD" for p in params]
    (want,), jscope = _train_jax(jmain, jstartup, jloss, state, [feed], grads)
    (got,), tscope = _train_port(tmain, tstartup, tloss, state, [feed], grads)
    np.testing.assert_allclose(got[0], want[0],
                               rtol=AMP_LOSS_RTOL[dest_dtype])
    after = persistables_to_numpy(tscope, tmain)

    def check(name, g, w):
        err = np.abs(np.asarray(g, np.float64) - w).max()
        assert err <= tol * np.abs(w).max(), (name, err)

    for p, g, w in zip(params, got[1:], want[1:]):
        vel = f"{p}_velocity_0"
        jvel, jp = (np.asarray(jscope.find_var(n), np.float64) for n in (vel, p))
        check(p + "@GRAD", g, w)
        check(vel, after[vel], jvel)
        check(p, after[p] - state[p], jp - state[p])
        decay = jvel - w
        err = np.abs(after[vel] - g - decay).max()
        assert err <= CONV_NET_DECAY_TOL * np.abs(decay).max(), (p, err)
        assert not state[vel].any()

@pytest.mark.parametrize("variant", ["bf16", "f16_dynamic"])
def test_every_var_of_an_amp_step_has_the_jax_runtime_dtype(variant):
    kw = VARIANTS[variant]
    jmain, jstartup, jloss, _ = _build(fluid, jax_names, True, **kw)
    tmain, tstartup, tloss, _ = _build(pt, torch_names, True, **kw)
    state = _jax_startup_state(jmain, jstartup)
    produced = sorted({n for op in tmain.global_block().ops
                       for n in op.output_names()})
    feed = _learnable(np.random.RandomState(3), 8)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(jstartup)
        want = exe.run(jmain, feed=feed, fetch_list=produced, return_numpy=False)
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    load_params(tscope, state)
    got = texe.run(tmain, feed=feed, fetch_list=produced, scope=tscope,
                   return_numpy=False)
    jax_dt = {n: convert_dtype(str(w.dtype)) for n, w in zip(produced, want)}
    port_dt = {n: convert_dtype(g.dtype) for n, g in zip(produced, got)}
    # the JAX package runs 64-bit types off: its int32 is the port's int32
    # or, for an index, int64
    assert set(port_dt) == set(jax_dt)
    assert {n: d for n, d in port_dt.items() if d != jax_dt[n]
            and not (jax_dt[n] == "int32" and d == "int64")} == {}
    assert any(d == kw["dest_dtype"] for d in jax_dt.values())


def _jax_op(op_type, ins, attrs):
    return JaxOps.get(op_type).lowering()(
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, attrs)


def _torch_op(op_type, ins, attrs):
    return TorchOps.get(op_type).lowering()(
        {k: [torch.from_numpy(np.asarray(a)) for a in v] for k, v in ins.items()},
        attrs)


def _np(x):
    return np.asarray(x if not isinstance(x, torch.Tensor) else x.numpy())


# the loss-scaling ops, one case each (test_torch_ops.py checks that every
# op type the port registers has a case in some test file)
CASES = {
    "check_finite_and_unscale": (
        {"X": [np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4) * 512,
               np.array([1.0, np.inf, -2.0], np.float16)],
         "Scale": [np.array([512.0], np.float32)]}, {}),
    "update_loss_scaling": (
        {"X": [np.ones((2, 3), np.float32)],
         "FoundInfinite": [np.array([True])],
         "PrevLossScaling": [np.array([1024.0], np.float32)],
         "InGoodSteps": [np.array([7], np.int32)],
         "InBadSteps": [np.array([1], np.int32)]},
        {"incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 2,
         "incr_ratio": 2.0, "decr_ratio": 0.5}),
}


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_loss_scaling_op_cases_equal_the_jax_ops(op_type):
    ins, attrs = CASES[op_type]
    want = _jax_op(op_type, ins, attrs)
    got = _torch_op(op_type, ins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert g.dtype == getattr(torch, str(w.dtype)), slot
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=slot)


@pytest.mark.parametrize("poison", [None, np.inf, np.nan])
def test_check_finite_and_unscale_equals_the_jax_op(poison):
    rng = np.random.RandomState(4)
    xs = [rng.randn(3, 5).astype(np.float32) * 1024,
          rng.randn(7).astype(np.float16)]
    if poison is not None:
        xs[1][3] = poison
    ins = {"X": xs, "Scale": [np.array([1024.0], np.float32)]}
    want = _jax_op("check_finite_and_unscale", ins, {})
    got = _torch_op("check_finite_and_unscale", ins, {})
    assert bool(_np(got["FoundInfinite"][0])[0]) == (poison is not None)
    np.testing.assert_array_equal(_np(got["FoundInfinite"][0]),
                                  _np(want["FoundInfinite"][0]))
    for g, w in zip(got["Out"], want["Out"]):
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("found,good,bad", [(False, 0, 0), (False, 999, 0),
                                            (True, 5, 0), (True, 0, 1)])
def test_update_loss_scaling_equals_the_jax_op(found, good, bad):
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3),
          np.ones(4, np.float16)]
    ins = {"X": xs, "FoundInfinite": [np.array([found])],
           "PrevLossScaling": [np.array([2.0 ** 15], np.float32)],
           "InGoodSteps": [np.array([good], np.int32)],
           "InBadSteps": [np.array([bad], np.int32)]}
    attrs = {"incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.5}
    want = _jax_op("update_loss_scaling", ins, attrs)
    got = _torch_op("update_loss_scaling", ins, attrs)
    for slot in ("LossScaling", "OutGoodSteps", "OutBadSteps", "Out"):
        for g, w in zip(got[slot], want[slot]):
            assert g.dtype == getattr(torch, str(w.dtype)), slot
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=slot)


def test_a_bf16_fetch_comes_back_as_float32():
    """numpy has no bfloat16: the port widens a bf16 fetch to float32,
    exactly (the JAX package returns ml_dtypes.bfloat16 arrays)."""
    main, startup, loss, _ = _build(pt, torch_names, True)
    cast = next(op.output("Out")[0] for op in main.global_block().ops
                if op.type == "cast" and op.attrs["out_dtype"] == "bfloat16")
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _learnable(np.random.RandomState(6), 8)
    arr, t = (exe.run(main, feed=feed, fetch_list=[cast], scope=scope,
                      return_numpy=r)[0] for r in (True, False))
    assert t.dtype == torch.bfloat16 and arr.dtype == np.float32
    np.testing.assert_array_equal(arr, t.float().numpy())


def test_amp_parameters_stay_float32_master_weights():
    """The rewrite casts parameters where they are read; the scope keeps
    float32 parameters, so JAX weights carry over in their own dtype."""
    jmain, jstartup, _, _ = _build(fluid, jax_names, True, **VARIANTS["f16_dynamic"])
    state = _jax_startup_state(jmain, jstartup)
    tmain, tstartup, tloss, _ = _build(pt, torch_names, True,
                                       **VARIANTS["f16_dynamic"])
    out, scope = _train_port(tmain, tstartup, tloss, state,
                             [_learnable(np.random.RandomState(7), 8)])
    after = persistables_to_numpy(scope, tmain)
    assert set(after) == set(state)
    for name, a in after.items():
        assert a.dtype == state[name].dtype, name
    params = [p.name for p in tmain.all_parameters()]
    assert params and all(after[p].dtype == np.float32 for p in params)


def test_float32_reductions_guard_restores_the_callers_settings():
    matmul = torch.backends.cuda.matmul
    names = ("allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    before = {n: getattr(matmul, n) for n in names}
    try:
        for n in names:
            setattr(matmul, n, True)
        with FLOAT32_REDUCTIONS:
            assert not any(getattr(matmul, n) for n in names)
            with FLOAT32_REDUCTIONS:
                assert not any(getattr(matmul, n) for n in names)
            assert not any(getattr(matmul, n) for n in names)
        assert all(getattr(matmul, n) for n in names)
        # nothing to set for a CPU tensor, or a float32 one
        x = torch.zeros(2, dtype=torch.bfloat16)
        with FLOAT32_REDUCTIONS.on(x):
            assert all(getattr(matmul, n) for n in names)
    finally:
        for n, v in before.items():
            setattr(matmul, n, v)
