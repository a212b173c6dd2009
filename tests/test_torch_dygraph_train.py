"""Dygraph training in the PyTorch port against the JAX package's, on
the CPU (the cases of ``tests/test_dygraph.py`` that train, run in both
packages from the same inputs; helpers in ``test_torch_dygraph.py``):
Linear with Adam (losses within rtol 1e-4 over 30 steps, the optimizer's
``state_dict`` names), the MLP against its static program
(``NumpyArrayInitializer``), the conv stack of ``chip_smoke.py``'s phase
14d at a small width (Conv2D, Pool2D, BatchNorm, Dropout, Linear; losses
within rtol 1e-5, grads and parameters within rtol 1e-4, atol 1e-5), and
``examples/recognize_digits_dygraph.py``'s recipe.
"""

import numpy as np

import paddle_tpu as fluid
from paddle_tpu import dygraph as jdg
from paddle_tpu.utils import unique_name as jax_names
import paddle_tpu_torch as pt
from paddle_tpu_torch.utils import unique_name as torch_names

from test_torch_dygraph import CPU, both, close, mean


def test_linear_trains_with_adam():
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 4).astype(np.float32)
    ys = xs @ rng.randn(4, 1).astype(np.float32)

    def run(pkg, dg):
        model = dg.Linear(4, 1)
        opt = pkg.optimizer.AdamOptimizer(learning_rate=0.1)
        losses = []
        for _ in range(30):
            diff = model(dg.to_variable(xs)) - dg.to_variable(ys)
            loss = mean(dg, diff * diff)
            loss.backward()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            losses.append(float(loss.numpy().reshape(-1)[0]))
        return losses, model.state_dict(), opt.state_dict()

    j, t = both(run)
    close(j[0], t[0], rtol=1e-4, atol=1e-6)
    close(j[1], t[1], rtol=1e-4, atol=1e-5)
    assert sorted(j[2]) == sorted(t[2])
    assert t[0][-1] < t[0][0] * 0.05

def test_mlp_static_dygraph_parity():
    rng = np.random.RandomState(1)
    xs = rng.randn(32, 8).astype(np.float32)
    ys = (rng.rand(32, 1) > 0.5).astype(np.float32)
    w0 = rng.randn(8, 16).astype(np.float32) * 0.1
    w1 = rng.randn(16, 1).astype(np.float32) * 0.1

    def dynamic(pkg, dg):
        init = pkg.initializer.NumpyArrayInitializer
        fc0 = dg.Linear(8, 16, param_attr=pkg.ParamAttr(initializer=init(w0)),
                        bias_attr=False, act="relu")
        fc1 = dg.Linear(16, 1, param_attr=pkg.ParamAttr(initializer=init(w1)),
                        bias_attr=False)
        opt = pkg.optimizer.SGDOptimizer(0.5)
        params = fc0.parameters() + fc1.parameters()
        losses = []
        for _ in range(5):
            logits = fc1(fc0(dg.to_variable(xs)))
            ce = dg.trace_op("sigmoid_cross_entropy_with_logits",
                             {"X": [logits], "Label": [dg.to_variable(ys)]},
                             {})["Out"][0]
            loss = mean(dg, ce)
            loss.backward()
            opt.minimize(loss, parameter_list=params)
            for p in params:
                p.clear_gradient()
            losses.append(float(loss.numpy().reshape(-1)[0]))
        return losses

    j, t = both(dynamic)
    close(j, t)
    # the port's own static program from the same weights
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.data("x", [32, 8], "float32")
        y = pt.data("y", [32, 1], "float32")
        init = pt.initializer.NumpyArrayInitializer
        h = pt.layers.fc(x, 16, act="relu", bias_attr=False,
                         param_attr=pt.ParamAttr(initializer=init(w0)))
        p = pt.layers.fc(h, 1, bias_attr=False,
                         param_attr=pt.ParamAttr(initializer=init(w1)))
        loss = pt.layers.mean(pt.layers.sigmoid_cross_entropy_with_logits(p, y))
        pt.optimizer.SGDOptimizer(0.5).minimize(loss)
    exe = pt.Executor(CPU)
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        static = [float(exe.run(main, feed={"x": xs, "y": ys},
                                fetch_list=[loss])[0].reshape(-1)[0])
                  for _ in range(5)]
    np.testing.assert_allclose(static, t, rtol=2e-4, atol=1e-6)

def _conv_stack(dg, width=(2, 3)):
    """Phase 14d's net of ``chip_smoke.py`` at a small width."""
    return dg.Sequential(
        dg.Conv2D(1, width[0], 5), dg.Pool2D(2, "max", 2),
        dg.BatchNorm(width[0]), dg.Conv2D(width[0], width[1], 5),
        dg.Pool2D(2, "max", 2),
        dg.Dropout(0.5, dropout_implementation="upscale_in_train"))

def test_conv_stack_with_dropout_trains_like_jax():
    """Two Adam steps on 16x16 images. The first conv's bias feeds
    BatchNorm, which takes it out again: its grad is rounding noise (about
    1e-6 against grads of order 1), which Adam scales to full steps, so
    the bias is held only in its grad."""
    rng = np.random.RandomState(2)
    imgs = rng.randn(4, 1, 16, 16).astype(np.float32)
    labels = rng.randint(0, 10, (4, 1)).astype(np.int64)

    def run(pkg, dg):
        body = _conv_stack(dg)
        fc = dg.Linear(3, 10)
        opt = pkg.optimizer.Adam(learning_rate=1e-3)
        params = body.parameters() + fc.parameters()
        losses, grads = [], []
        for _ in range(2):
            h = body(dg.to_variable(imgs))
            h = dg.trace_op("reshape2", {"X": [h]}, {"shape": [4, -1]})["Out"][0]
            ce = dg.trace_op("softmax_with_cross_entropy",
                             {"Logits": [fc(h)], "Label": [dg.to_variable(labels)]},
                             {})["Loss"][0]
            loss = mean(dg, ce)
            loss.backward()
            grads.append([p.gradient() for p in params])
            opt.minimize(loss, parameter_list=params)
            for p in params:
                p.clear_gradient()
            losses.append(loss.numpy())
        state = body.state_dict()
        del state[body[0].bias.name]
        return losses, grads, state

    j, t = both(run, seed=3)
    close(j[0], t[0])
    close(j[1], t[1], rtol=1e-4, atol=1e-5)
    close(j[2], t[2], rtol=1e-4, atol=1e-5)

def test_mnist_recipe_matches_jax_and_its_capture():
    """``examples/recognize_digits_dygraph.py``'s ``main`` (784-64-10,
    batch 32, SGD 0.1, 8 steps, seed 0): the port's eager losses are
    bit-equal to its ``to_static`` captures and within 1e-5 of the JAX
    dygraph's eager ones (the example's own model, loss and data; its
    capture gate is the JAX package's, left to ``tests/test_examples.py``);
    the loss falls."""
    from examples.recognize_digits_dygraph import (
        build_model, compute_loss, synthetic_digits)
    from paddle_tpu_torch.models.mnist import dygraph_mnist_recipe

    imgs, labels = synthetic_digits(np.random.RandomState(0), 8 * 32)
    j_eager = []
    with jax_names.guard(), jdg.guard(seed=0):
        model = build_model()
        opt = fluid.optimizer.SGD(learning_rate=0.1)
        for step in range(8):
            rows = slice(step * 32, (step + 1) * 32)
            loss = compute_loss(model, jdg.to_variable(imgs[rows]),
                                jdg.to_variable(labels[rows]))
            loss.backward()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            j_eager.append(float(loss.numpy().reshape(-1)[0]))
    with torch_names.guard():
        t_eager, t_captured = dygraph_mnist_recipe(place=CPU)
    assert t_eager == t_captured
    np.testing.assert_allclose(t_eager, j_eager, rtol=1e-5, atol=1e-6)
    assert t_eager[-1] < t_eager[0]
