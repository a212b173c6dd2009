"""Dygraph in the PyTorch port against the JAX package's, on the CPU:
the tape and the layers of ``tests/test_dygraph.py``, each case run in
both packages from the same numpy inputs (``dygraph.guard(place=
CPUPlace())`` in the port) under each package's ``unique_name.guard()``,
so names line up.

* Initial weights (``eager_initialize`` through the tracer's keys) and
  dropout masks bit for bit; values and grads within rtol 1e-5, atol
  1e-6 (float32 sums in another order; grads of the layers rtol = atol =
  1e-5).
* The tape: grads through two uses, ``stop_gradient``/``detach``,
  ``no_grad``, a second ``backward`` over a retained tape replacing the
  first's grads (the JAX package's ``_accumulate_grad``).
* The layers (Conv2DTranspose, LayerNorm, GroupNorm, InstanceNorm,
  Embedding, PRelu, GRUUnit) forward and backward; BatchNorm's running
  statistics.

``test_torch_dygraph_train.py`` trains, ``test_torch_dygraph_jit.py``
holds dygraph-to-static and the files.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import dygraph as jdg
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu.utils.enforce import EnforceError as JEnforceError
import paddle_tpu_torch as pt
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.enforce import EnforceError as TEnforceError

CPU = pt.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-6)

# (package, its dygraph, a guard factory, names, EnforceError)
JAX = (fluid, jdg, lambda seed: jdg.guard(seed=seed), jax_names, JEnforceError)
PORT = (pt, tdg, lambda seed: tdg.guard(place=CPU, seed=seed), torch_names,
        TEnforceError)

def both(fn, seed=0):
    """``fn(pkg, dg)`` in each package's guard: (jax result, port result)."""
    out = []
    for pkg, dg, guard, names, _ in (JAX, PORT):
        with names.guard(), guard(seed):
            out.append(fn(pkg, dg))
    return out

def close(a, b, **tol):
    tol = tol or TOL
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            close(a[k], b[k], **tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y, **tol)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **tol)

def same(a, b):
    close(a, b, rtol=0, atol=0)

def mean(dg, x):
    return dg.trace_op("mean", {"X": [x]}, {})["Out"][0]

def test_basic_eager_math_and_backward():
    def run(pkg, dg):
        x = dg.to_variable(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
        x.stop_gradient = False
        loss = mean(dg, x * x + x)
        loss.backward()
        return loss.numpy(), x.gradient()

    j, t = both(run)
    close(j, t)
    np.testing.assert_allclose(t[1], (2 * np.array([[1, 2], [3, 4]]) + 1) / 4)

def test_grads_add_over_uses_and_stop_at_detach():
    def run(pkg, dg):
        x = dg.to_variable(np.ones((3,), np.float32))
        x.stop_gradient = False
        s = x * 2.0 + x * 3.0 + (x * 7.0).detach()
        loss = dg.trace_op("reduce_sum", {"X": [s]}, {"reduce_all": True})["Out"][0]
        loss.backward()
        y = dg.to_variable(np.ones((2, 2), np.float32))
        y.stop_gradient = False
        mean(dg, (y * 2.0).detach() * 3.0).backward()
        return x.gradient(), y.gradient()

    j, t = both(run)
    same(j, t)
    np.testing.assert_array_equal(t[0], [5.0, 5.0, 5.0])

def test_no_grad_and_a_second_backward():
    """``no_grad`` records nothing; a second ``backward`` over a retained
    tape gives the same grads, which replace the first's (the JAX
    package's rule), and then clears the tape."""
    def run(pkg, dg):
        x = dg.to_variable(np.arange(4, dtype=np.float32))
        x.stop_gradient = False
        with dg.no_grad():
            y = x * 2.0
        assert y.stop_gradient and not dg._dygraph_tracer()._tape
        loss = mean(dg, x * x)
        loss.backward(retain_graph=True)
        first = x.gradient()
        n = len(dg._dygraph_tracer()._tape)
        loss.backward()
        return first, x.gradient(), n, len(dg._dygraph_tracer()._tape)

    j, t = both(run)
    same(j, t)
    assert t[2] == 2 and t[3] == 0

def test_initial_weights_and_dropout_masks_bit_for_bit():
    def run(pkg, dg):
        layers = [dg.Linear(7, 5), dg.Conv2D(3, 4, 3), dg.Embedding([11, 6]),
                  dg.BatchNorm(4), dg.LayerNorm(5), dg.GroupNorm(4, 2),
                  dg.Conv2DTranspose(4, 2, 3), dg.GRUUnit(9),
                  dg.PRelu("channel", channel=4), dg.InstanceNorm(3)]
        state = [l.state_dict() for l in layers]
        drop = dg.Dropout(0.5)
        up = dg.Dropout(0.3, dropout_implementation="upscale_in_train")
        x = dg.to_variable(np.ones((4, 50), np.float32))
        masks = [drop(x).numpy(), up(x).numpy(), drop(x).numpy()]
        drop.eval()
        masks.append(drop(x).numpy())
        return state, masks

    (js, jm), (ts, tm) = both(run, seed=11)
    same(js, ts)
    same(jm, tm)
    assert not np.array_equal(tm[0], tm[2])      # the key stream moved

@pytest.mark.parametrize("layer", ["Conv2DTranspose", "LayerNorm", "GroupNorm",
                                   "InstanceNorm", "Embedding", "PRelu",
                                   "GRUUnit"])
def test_layer_forward_and_backward(layer):
    rng = np.random.RandomState(4)
    x4 = rng.randn(2, 4, 5, 5).astype(np.float32)
    gx = rng.randn(3, 12).astype(np.float32)
    gh = rng.randn(3, 4).astype(np.float32)

    def run(pkg, dg):
        if layer == "Embedding":
            m = dg.Embedding([10, 6])
            out = m(dg.to_variable(np.array([[1, 2], [3, 1]], np.int64)))
        elif layer == "GRUUnit":
            m = dg.GRUUnit(12)
            out = m(dg.to_variable(gx), dg.to_variable(gh))[0]
        else:
            m = {"Conv2DTranspose": lambda: dg.Conv2DTranspose(4, 3, 3, stride=2),
                 "LayerNorm": lambda: dg.LayerNorm([5, 5], begin_norm_axis=2),
                 "GroupNorm": lambda: dg.GroupNorm(4, 2),
                 "InstanceNorm": lambda: dg.InstanceNorm(4),
                 "PRelu": lambda: dg.PRelu("channel", channel=4)}[layer]()
            out = m(dg.to_variable(x4))
        loss = mean(dg, out * out)
        loss.backward()
        return out.numpy(), [p.gradient() for p in m.parameters()]

    j, t = both(run)
    close(j[0], t[0])
    close(j[1], t[1], rtol=1e-5, atol=1e-5)

def test_batchnorm_running_stats():
    x = np.random.RandomState(0).randn(4, 3, 2, 2).astype(np.float32) * 5 + 2

    def run(pkg, dg):
        bn = dg.BatchNorm(3)
        bn.train()
        y = bn(dg.to_variable(x)).numpy()
        stats = bn._mean.numpy(), bn._variance.numpy()
        bn.eval()
        return y, stats, bn(dg.to_variable(x)).numpy()

    j, t = both(run)
    close(j, t)
    assert not np.allclose(t[1][0], 0)
