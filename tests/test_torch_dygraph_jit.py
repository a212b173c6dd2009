"""Dygraph-to-static and dygraph files in the PyTorch port against the
JAX package's, on the CPU (helpers in ``test_torch_dygraph.py``):

* ``save_dygraph`` in one package and ``load_dygraph`` in the other;
  ``convert.load_layer_state`` by order;
* ``TracedLayer``: eager against traced, and each package's
  ``save_inference_model`` served by the other package's predictor
  within rtol 1e-5, atol 1e-6;
* the loud errors of a Python branch on a traced value;
* every ``declarative`` case of ``tests/test_dygraph.py`` (data-dependent
  ``if``/``while``/``for``, nested, walrus, row iteration, the errors),
  each function converted by both packages: the same values.
"""

import numpy as np
import pytest

from paddle_tpu import dygraph as jdg
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jpredictor
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch.convert import load_layer_state
from paddle_tpu_torch.inference import Config as TConfig
from paddle_tpu_torch.inference import create_predictor as tpredictor
from paddle_tpu_torch.utils import unique_name as torch_names

from test_torch_dygraph import CPU, JAX, PORT, TOL, close, mean


def test_save_in_one_package_load_in_the_other(tmp_path):
    x = np.random.RandomState(5).randn(2, 4).astype(np.float32)

    def model(dg):
        return dg.Sequential(dg.Linear(4, 8, act="relu"), dg.Linear(8, 2))

    with jax_names.guard(), jdg.guard(seed=1):
        jm = model(jdg)
        jout = jm(jdg.to_variable(x)).numpy()
        jdg.save_dygraph(jm.state_dict(), str(tmp_path / "jax"))
    with torch_names.guard(), tdg.guard(place=CPU, seed=2):
        tm = model(tdg)
        params, opt = tdg.load_dygraph(str(tmp_path / "jax"))
        assert opt is None
        tm.set_dict(params)
        np.testing.assert_allclose(tm(tdg.to_variable(x)).numpy(), jout, **TOL)
        tdg.save_dygraph(tm.state_dict(), str(tmp_path / "port"))
        other = model(tdg)                  # other names: load by order
        load_layer_state(other, jm.state_dict(), by_order=True)
        np.testing.assert_allclose(other(tdg.to_variable(x)).numpy(), jout,
                                   **TOL)
    with jax_names.guard(), jdg.guard(seed=3):
        jm2 = model(jdg)
        jm2.set_dict(jdg.load_dygraph(str(tmp_path / "port"))[0])
        np.testing.assert_allclose(jm2(jdg.to_variable(x)).numpy(), jout, **TOL)

def test_traced_layer_across_packages(tmp_path):
    """The port's traced program matches its eager run; each package's
    ``save_inference_model`` serves through the other's predictor."""
    x = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    outs = {}
    for (pkg, dg, guard, names, _), tag in ((JAX, "jax"), (PORT, "port")):
        with names.guard(), guard(0):
            m = dg.Sequential(dg.Linear(4, 8, act="relu"), dg.Linear(8, 2))
            m.eval()
            dy, traced = dg.TracedLayer.trace(m, [dg.to_variable(x)])
            st = traced([dg.to_variable(x)])[0]
            np.testing.assert_allclose(st.numpy(), dy.numpy(), **TOL)
            traced.save_inference_model(str(tmp_path / tag))
            outs[tag] = dy.numpy()
    for src, Config, create in (("jax", TConfig, tpredictor),
                                ("port", JConfig, jpredictor)):
        cfg = Config(str(tmp_path / src))
        cfg.disable_gpu()
        pred = create(cfg)
        (got,) = pred.run([x])
        np.testing.assert_allclose(np.asarray(got), outs[src], **TOL)

def test_eager_branch_and_loud_trace_errors():
    class Branchy:
        def __init__(self, dg):
            self.dg = dg

        def __call__(self, x):
            if mean(self.dg, x) > 0:
                return x * 2.0
            return x

    class IntLayer:
        def __init__(self, dg):
            self.dg = dg

        def __call__(self, x):
            return x * float(int(mean(self.dg, x)))

    for pkg, dg, guard, names, err in (JAX, PORT):
        with names.guard(), guard(0):
            x = dg.to_variable(np.array([2.0], np.float32))
            if x > 1.0:
                y = x * 10.0
            else:
                y = x
            np.testing.assert_allclose(y.numpy(), [20.0])
            for layer in (Branchy(dg), IntLayer(dg)):
                with pytest.raises(err, match="layers.cond"):
                    dg.TracedLayer.trace(layer, [x])

# -- declarative -------------------------------------------------------------
#
# Each function is converted by both packages (their helpers sit in this
# module's globals under different keys); ``DG`` is the dygraph module of
# the package running it.

DG = None

def _mean(x):
    return DG.trace_op("mean", {"X": [x]}, {})["Out"][0]

def d_if(x):
    s = _mean(x)
    if s > 0:
        y = x * 2.0
    else:
        y = x * -1.0
    return y

def d_if_nested(x):
    s = _mean(x)
    y = x
    if s > 1.0:
        y = y + 10.0
        if s > 2.0:
            y = y + 100.0
    return y

def d_while(x):
    s = _mean(x)
    while s > 0:
        s = s - 1.0
    return s

def d_rnn(x, w0):
    h = x[0] * 0.0
    for t in range(4):
        h = DG.trace_op("tanh", {"X": [h @ w0 + x[t]]}, {})["Out"][0]
    return h

def d_for_tensor_bound(x, n):
    acc = x * 0.0
    for i in range(n):
        acc = acc + x
    return acc

def d_for_loop_var(x):
    for i in range(3):
        x = x + 1.0
    return x * i

def d_for_reassign(x):
    acc = x * 0.0
    for i in range(3):
        i = i * 10
        acc = acc + x
    return acc

def d_walrus(x, n):
    w = x * 0.0
    s = _mean(x) * 0.0
    while s < n:
        s = s + (w := s + 1.0) * 0.0 + 1.0
    return w

def d_static_guard(x, flag=None):
    if flag is not None:
        return x
    s = _mean(x)
    if s > 0:
        y = x * 2.0
    else:
        y = x * 3.0
    return y

def d_nested_def(x):
    s = _mean(x)
    if s > 0:
        def scale2(t):
            w = t * 2.0
            return w
        y = scale2(x)
        for i in range(3):
            if i == 1:
                break
    else:
        y = x * 5.0
    return y

def d_mixed(x):
    s = _mean(x)
    y = 0.0
    if s > 0:
        y = x * 2.0
    return x + y

def d_if_in_loop(x, n):
    s = _mean(x) * 0.0
    acc = x * 0.0
    while s < n:
        if acc[0] > 2.0:
            acc = acc + 0.5
        else:
            acc = acc + 1.0
        s = s + 1.0
    return acc

def d_nested_loops(x, n):
    total = x * 0.0
    i = _mean(x) * 0.0
    while i < n:
        j = i * 0.0
        while j < i + 1.0:
            total = total + 1.0
            j = j + 1.0
        i = i + 1.0
    return total

def d_rows(x):
    acc = x[0] * 0.0
    for row in x:
        acc = acc + row
    return acc

def d_one_sided_ok(x):
    s = _mean(x)
    if s > 0:
        fresh = x * 2.0  # noqa: F841
    return x + 0.0

def d_one_sided_bad(x):
    s = _mean(x)
    if s > 0:
        fresh = x * 2.0
    return fresh + 0.0

def d_side_effect(x):
    s = _mean(x)
    if s > 0:
        DG.trace_op("scale", {"X": [x]}, {"scale": 2.0})
    return x + 0.0

def d_break(x):
    s = _mean(x)
    while s > 0:
        s = s - 1.0
        if False:
            break
    return s

_F = lambda *v: np.asarray(v, np.float32)  # noqa: E731
_W = np.random.RandomState(0).randn(3, 3).astype(np.float32) * 0.3
_XS = np.random.RandomState(1).randn(4, 2, 3).astype(np.float32)

DECLARATIVE = {
    "if": (d_if, [[np.full((2, 2), 3.0, np.float32)],
                  [np.full((2, 2), -3.0, np.float32)]]),
    "if_nested": (d_if_nested, [[_F(0.5, 0.5)], [_F(1.5, 1.5)], [_F(2.5, 2.5)]]),
    "while": (d_while, [[_F(3.0, 3.0)], [_F(1.5, 1.5)]]),
    "rnn": (d_rnn, [[_XS, _W]]),
    "for_tensor_bound": (d_for_tensor_bound,
                         [[_F(1.5, 1.5), np.asarray(3, np.int32)],
                          [_F(1.5, 1.5), np.asarray(5, np.int32)]]),
    "for_loop_var": (d_for_loop_var, [[_F(1.0, 1.0)]]),
    "for_reassign": (d_for_reassign, [[_F(1.0, 1.0)]]),
    "walrus": (d_walrus, [[_F(0.0), np.asarray(3.0, np.float32)]]),
    "static_guard": (d_static_guard, [[_F(1.0, 1.0)], [_F(-1.0, -1.0)]]),
    "nested_def": (d_nested_def, [[_F(1.0, 1.0)], [_F(-1.0, -1.0)]]),
    "mixed": (d_mixed, [[_F(1.0, 1.0)], [_F(-1.0, -1.0)]]),
    "if_in_loop": (d_if_in_loop, [[_F(0.0), np.asarray(5.0, np.float32)],
                                  [_F(0.0), np.asarray(2.0, np.float32)]]),
    "nested_loops": (d_nested_loops, [[_F(0.0), np.asarray(3.0, np.float32)]]),
    "rows": (d_rows, [[np.arange(6, dtype=np.float32).reshape(3, 2)]]),
    "one_sided_ok": (d_one_sided_ok, [[_F(1.0, 1.0)]]),
}
ERRORS = {"one_sided_bad": (d_one_sided_bad, RuntimeError, "every path"),
          "side_effect": (d_side_effect, RuntimeError, "side-effect"),
          "break": (d_break, None, "layers.cond")}

@pytest.mark.parametrize("case", sorted(DECLARATIVE))
def test_declarative_matches_jax(case):
    global DG
    fn, calls = DECLARATIVE[case]
    results = []
    for pkg, dg, guard, names, _ in (JAX, PORT):
        DG = dg
        with names.guard(), guard(0):
            f = dg.declarative(fn)
            results.append([f(*[dg.to_variable(a) for a in args]).numpy()
                            for args in calls])
    close(results[0], results[1])

@pytest.mark.parametrize("case", sorted(ERRORS))
def test_declarative_errors_match_jax(case):
    global DG
    fn, err, match = ERRORS[case]
    for pkg, dg, guard, names, enforce_error in (JAX, PORT):
        DG = dg
        with names.guard(), guard(0):
            f = dg.declarative(fn)
            with pytest.raises(err or enforce_error, match=match):
                f(dg.to_variable(_F(1.0, 1.0)))
