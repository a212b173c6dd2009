"""The book programs in the PyTorch port against the JAX package, on the
CPU: ``fit_a_line`` (``examples/fit_a_line.py``'s program: ``fc``,
``square_error_cost``, ``mean``, SGD 0.01), ``recognize_digits``
(``examples/recognize_digits.py``'s: conv/pool twice, ``reshape``, ``fc``
with softmax, ``cross_entropy``, ``accuracy``, Adam 1e-3) and
``models/mnist.py``'s ``build_mnist_train`` (the MLP and the conv net,
softmax cross entropy, Adam 1e-3).

Each program is built by the same function over either package (their
layer APIs are the same), so both emit the same ops; the JAX startup's
weights carry into the port by name, both run the same seeded batches,
and the loss streams agree within rtol 1e-5, atol 1e-6 (float32 sums in
another order; measured at most 1.3e-7 relative), the accuracy streams
exactly, and the loss falls.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from examples.recognize_digits import synthetic_digits
from paddle_tpu.models import mnist as jax_mnist
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.models import mnist as torch_mnist
from paddle_tpu_torch.utils import unique_name as torch_names

STEPS = 6
LOSS_TOL = (1e-5, 1e-6)


def fit_a_line(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod.data("x", shape=[-1, 13], dtype="float32")
        y = mod.data("y", shape=[-1, 1], dtype="float32")
        y_predict = mod.layers.fc(x, size=1, act=None)
        avg_cost = mod.layers.mean(mod.layers.square_error_cost(y_predict, y))
        mod.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
    return main, startup, [avg_cost]


def recognize_digits(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        img = mod.data("img", shape=[-1, 1, 28, 28], dtype="float32")
        label = mod.data("label", shape=[-1, 1], dtype="int64")
        c1 = mod.layers.conv2d(img, num_filters=8, filter_size=5, act="relu")
        p1 = mod.layers.pool2d(c1, pool_size=2, pool_stride=2)
        c2 = mod.layers.conv2d(p1, num_filters=16, filter_size=5, act="relu")
        p2 = mod.layers.pool2d(c2, pool_size=2, pool_stride=2)
        flat = mod.layers.reshape(p2, [0, 16 * 4 * 4])
        prediction = mod.layers.fc(flat, size=10, act="softmax")
        loss = mod.layers.mean(mod.layers.cross_entropy(prediction, label))
        acc = mod.layers.accuracy(prediction, label)
        mod.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, [loss, acc]


def _line_batches():
    rng = np.random.RandomState(0)
    w_true = rng.randn(13, 1).astype("float32")
    xs = rng.randn(20 * STEPS, 13).astype("float32")
    ys = xs @ w_true + 0.1 * rng.randn(20 * STEPS, 1).astype("float32")
    return [{"x": xs[i:i + 20], "y": ys[i:i + 20]}
            for i in range(0, 20 * STEPS, 20)]


def _digit_batches(flat=False):
    xs, ys = synthetic_digits(np.random.RandomState(0), 16 * STEPS)
    if flat:
        xs = xs.reshape(len(xs), 784)
    return [{"img": xs[i:i + 16], "label": ys[i:i + 16]}
            for i in range(0, 16 * STEPS, 16)]


PROGRAMS = {
    "fit_a_line": (fit_a_line, _line_batches),
    "recognize_digits": (recognize_digits, _digit_batches),
    "mnist_conv": (lambda mod: _mnist(mod, True), _digit_batches),
    "mnist_mlp": (lambda mod: _mnist(mod, False),
                  lambda: _digit_batches(flat=True)),
}


def _mnist(mod, use_conv):
    models = jax_mnist if mod is fluid else torch_mnist
    main, startup, _, fetches = models.build_mnist_train(use_conv=use_conv)
    return main, startup, fetches


def _build(name, mod, names):
    with names.guard():
        return PROGRAMS[name][0](mod)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_the_jax_builder(name):
    for i in (0, 1):
        want = _build(name, fluid, jax_names)[i].global_block()
        got = _build(name, pt, torch_names)[i].global_block()
        assert [op.desc() for op in got.ops] == [op.desc() for op in want.ops]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_loss_stream_matches_jax(name):
    jmain, jstartup, jfetch = _build(name, fluid, jax_names)
    tmain, tstartup, tfetch = _build(name, pt, torch_names)
    batches = PROGRAMS[name][1]()
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.asarray(jscope.find_var(v.name))
                 for v in jmain.global_block().vars.values()
                 if v.persistable and jscope.find_var(v.name) is not None}
        want = [jexe.run(jmain, feed=b, fetch_list=[f.name for f in jfetch])
                for b in batches]
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    load_params(tscope, state)
    got = [texe.run(tmain, feed=b, fetch_list=[f.name for f in tfetch],
                    scope=tscope) for b in batches]
    rtol, atol = LOSS_TOL
    losses = np.array([g[0][0] for g in got])
    np.testing.assert_allclose(losses, [w[0][0] for w in want], rtol=rtol,
                               atol=atol)
    if len(tfetch) > 1:
        np.testing.assert_array_equal([g[1] for g in got],
                                      [w[1] for w in want])
    assert losses[-1] < losses[0]
