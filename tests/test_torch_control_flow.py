"""Static control flow in the PyTorch port against the JAX package, on
the CPU: ``layers.While`` and ``layers.cond`` programs built by each
package from the same builder calls (under each package's
``unique_name.guard()``, so the names line up) give the JAX executor's
fetches; the op types dygraph's layers reach hold against the JAX
lowerings, op by op and grad by grad.

* ``while``: a counted loop (``tests/test_framework.py``'s), a loop whose
  trip count comes from a feed, a nested loop, a loop whose body draws
  ``uniform_random`` (iteration ``i`` folds ``i`` into the run key, as
  the JAX body does: bit-equal draws), and a body temporary that does not
  outlive the loop;
* ``cond``: both arms on fed predicates, one output and two, a cond
  inside a while body; without a false branch the outputs need a value
  before it (the JAX package's error);
* the TensorArray layers raise ``NotImplementedError`` naming M12;
* ops: ``prelu`` (all / channel), ``conv2d_transpose`` (stride, groups,
  symmetric and 4-element padding), ``instance_norm``, ``group_norm``,
  the comparisons and logical ops, ``less_than_scalar``; float results
  within rtol 1e-5, atol 1e-6, grads within rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.utils import unique_name as torch_names
from test_torch_conv import _grad_op
from test_torch_train_ops import _assert_same, _run_jax, _run_torch


def _both(build, feeds, fetch_idx=None):
    """Build ``build(pkg)`` in both packages, run it once from a fresh
    scope and return (jax fetches, port fetches)."""
    outs = []
    for pkg, names, place in ((fluid, jax_names, fluid.CPUPlace()),
                              (pt, torch_names, pt.CPUPlace())):
        main, startup = pkg.Program(), pkg.Program()
        with names.guard(), pkg.program_guard(main, startup):
            fetches = build(pkg)
        main.random_seed = startup.random_seed = 7
        exe = pkg.Executor(place)
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            runs = [exe.run(main, feed=f, fetch_list=fetches) for f in feeds]
        outs.append([[np.asarray(v) for v in r] for r in runs])
    return outs


def _equal(jax_runs, torch_runs, rtol=0.0, atol=0.0):
    for jr, tr in zip(jax_runs, torch_runs):
        assert len(jr) == len(tr)
        for j, t in zip(jr, tr):
            assert j.shape == t.shape
            np.testing.assert_allclose(t, j.astype(t.dtype), rtol=rtol,
                                       atol=atol)


def _counted(pkg):
    L = pkg.layers
    i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    limit = L.fill_constant(shape=[1], dtype="float32", value=5.0)
    cond = L.less_than(i, limit)
    with L.While(cond).block():
        ni = L.increment(i, value=1.0, in_place=False)
        na = L.elementwise_add(acc, ni)
        L.assign(ni, i)
        L.assign(na, acc)
        L.less_than(i, limit, cond=cond)
    return [acc, i]


def test_counted_while_loop():
    j, t = _both(_counted, [{}])
    _equal(j, t)
    assert float(t[0][0][0]) == 15.0


def _fed_trip_count(pkg):
    L = pkg.layers
    n = pkg.data("n", [1], "float32")
    x = pkg.data("x", [3], "float32")
    i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    acc = L.fill_constant(shape=[3], dtype="float32", value=1.0)
    cond = L.less_than(i, n)
    with L.While(cond):
        L.assign(L.elementwise_add(L.elementwise_mul(acc, x), x), acc)
        L.increment(i, value=1.0)
        L.less_than(i, n, cond=cond)
    return [acc]


@pytest.mark.parametrize("n", [0.0, 1.0, 4.0])
def test_while_trip_count_from_a_feed(n):
    x = np.array([0.5, -1.5, 2.0], np.float32)
    j, t = _both(_fed_trip_count, [{"n": np.array([n], np.float32), "x": x}])
    _equal(j, t, rtol=1e-6)


def _nested(pkg):
    L = pkg.layers
    i = L.fill_constant([1], "float32", 0.0)
    total = L.fill_constant([1], "float32", 0.0)
    three = L.fill_constant([1], "float32", 3.0)
    c_out = L.less_than(i, three)
    with L.While(c_out):
        j = L.fill_constant([1], "float32", 0.0)
        lim = L.elementwise_add(i, L.fill_constant([1], "float32", 1.0))
        c_in = L.less_than(j, lim)
        with L.While(c_in):
            L.assign(L.elementwise_add(total, L.elementwise_mul(i, j)), total)
            L.increment(j, value=1.0)
            L.less_than(j, lim, cond=c_in)
        # the outer body carries what it writes itself: the inner while
        # op lists no outputs, so ``total`` is written here too
        L.assign(L.scale(total, 1.0), total)
        L.increment(i, value=1.0)
        L.less_than(i, three, cond=c_out)
    return [total]


def test_nested_while_loops():
    j, t = _both(_nested, [{}])
    _equal(j, t)
    # sum over i < 3 of i * (0 + ... + i)
    assert float(t[0][0][0]) == 0 * 0 + 1 * 1 + 2 * 3


def _random_body(pkg):
    L = pkg.layers
    i = L.fill_constant([1], "float32", 0.0)
    acc = L.fill_constant([4], "float32", 0.0)
    n = L.fill_constant([1], "float32", 3.0)
    cond = L.less_than(i, n)
    with L.While(cond):
        u = L.uniform_random([4], min=-1.0, max=1.0)
        L.assign(L.elementwise_add(acc, L.elementwise_mul(u, u)), acc)
        L.increment(i, value=1.0)
        L.less_than(i, n, cond=cond)
    return [acc]


def test_while_body_draws_a_new_key_each_iteration():
    """Two runs of the same program: each draws other bits (the run
    counter), each iteration other bits (the iteration folded in), and
    both equal the JAX executor's."""
    j, t = _both(_random_body, [{}, {}])
    _equal(j, t, rtol=1e-6)
    assert not np.array_equal(t[0][0], t[1][0])


def _temporary(pkg):
    L = pkg.layers
    i = L.fill_constant([1], "float32", 0.0)
    n = L.fill_constant([1], "float32", 2.0)
    cond = L.less_than(i, n)
    with L.While(cond):
        tmp = L.scale(i, scale=10.0)
        L.assign(L.elementwise_add(i, L.fill_constant([1], "float32", 1.0)), i)
        L.less_than(i, n, cond=cond)
    return [i], tmp.name


def test_body_temporaries_do_not_outlive_the_loop():
    """``_sub_block_rw``: ``i`` (it has a value before) is carried; the
    body's ``scale`` output is a temporary, not written out."""
    main, startup = pt.Program(), pt.Program()
    with torch_names.guard(), pt.program_guard(main, startup):
        fetch, tmp = _temporary(pt)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        assert float(exe.run(main, fetch_list=fetch)[0][0]) == 2.0
        with pytest.raises(pt.EnforceError, match=tmp):
            exe.run(main, fetch_list=[tmp])


def _two_arms(pkg):
    L = pkg.layers
    x = pkg.data("x", [2], "float32")
    p = L.greater_than(L.reduce_sum(x), L.fill_constant([1], "float32", 0.0))
    one = L.cond(p, lambda: L.scale(x, 2.0), lambda: L.scale(x, -1.0))
    a, b = L.cond(p, lambda: (L.scale(x, 3.0), L.elementwise_add(x, x)),
                  lambda: (x, L.elementwise_mul(x, x)))
    return [one, a, b]


def test_cond_runs_the_arm_its_predicate_picks():
    feeds = [{"x": np.array([1.0, 2.0], np.float32)},
             {"x": np.array([-1.0, -2.5], np.float32)}]
    j, t = _both(_two_arms, feeds)
    _equal(j, t)
    np.testing.assert_array_equal(t[0][0], [2.0, 4.0])
    np.testing.assert_array_equal(t[1][0], [1.0, 2.5])


def _cond_in_loop(pkg):
    L = pkg.layers
    i = L.fill_constant([1], "float32", 0.0)
    acc = L.fill_constant([1], "float32", 0.0)
    n = L.fill_constant([1], "float32", 5.0)
    two = L.fill_constant([1], "float32", 2.0)
    cond = L.less_than(i, n)
    with L.While(cond):
        big = L.greater_than(acc, two)
        step = L.cond(big, lambda: L.fill_constant([1], "float32", 0.5),
                      lambda: L.fill_constant([1], "float32", 1.0))
        L.assign(L.elementwise_add(acc, step), acc)
        L.increment(i, value=1.0)
        L.less_than(i, n, cond=cond)
    return [acc]


def test_cond_inside_a_while_body():
    j, t = _both(_cond_in_loop, [{}])
    _equal(j, t)
    assert float(t[0][0][0]) == 4.0


def test_cond_without_false_branch_needs_prior_values():
    for pkg, names, place in ((fluid, jax_names, fluid.CPUPlace()),
                              (pt, torch_names, pt.CPUPlace())):
        main, startup = pkg.Program(), pkg.Program()
        with names.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [2], "float32")
            p = pkg.layers.greater_than(
                pkg.layers.reduce_sum(x),
                pkg.layers.fill_constant([1], "float32", 0.0))
            with pytest.raises(pkg.EnforceError, match="both branches"):
                pkg.layers.cond(p, lambda: pkg.layers.scale(x, 2.0))
            pkg.layers.cond(p, lambda: None)    # no outputs: fine
        exe = pkg.Executor(place)
        with pkg.scope_guard(pkg.Scope()):
            exe.run(main, feed={"x": np.ones(2, np.float32)}, fetch_list=[x])


def test_tensor_array_layers_wait_for_m12():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.fill_constant([1], "float32", 1.0)
        i = pt.layers.fill_constant([1], "int64", 0)
        with pytest.raises(NotImplementedError, match="M12"):
            pt.layers.array_write(x, i)
        with pytest.raises(NotImplementedError, match="M12"):
            pt.layers.array_read(x, i)


# -- op lowerings ------------------------------------------------------------

R = np.random.RandomState(19)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


_BOOL_A = R.rand(3, 4) > 0.5
_BOOL_B = R.rand(3, 4) > 0.5
_X, _Y = f32(3, 4), f32(3, 4)
_Y[0] = _X[0]                       # some equal elements

CASES = {
    "prelu-all": ("prelu", {"X": [f32(2, 3, 4, 4)], "Alpha": [f32(1)]},
                  {"mode": "all"}),
    "prelu-channel": ("prelu", {"X": [f32(2, 3, 4, 4)], "Alpha": [f32(3)]},
                      {"mode": "channel"}),
    "conv2d_transpose-stride2": (
        "conv2d_transpose", {"Input": [f32(2, 4, 5, 5)],
                             "Filter": [f32(4, 3, 3, 3)]},
        {"strides": [2, 2], "paddings": [1, 1], "groups": 1}),
    "conv2d_transpose-groups2": (
        "conv2d_transpose", {"Input": [f32(2, 4, 5, 6)],
                             "Filter": [f32(4, 2, 3, 2)]},
        {"strides": [1, 2], "paddings": [0, 0], "groups": 2}),
    "conv2d_transpose-pad4": (
        "conv2d_transpose", {"Input": [f32(1, 2, 4, 4)],
                             "Filter": [f32(2, 3, 3, 3)]},
        {"strides": [2, 2], "paddings": [1, 0, 0, 2], "groups": 1}),
    "instance_norm": ("instance_norm", {"X": [f32(2, 3, 4, 5)],
                                        "Scale": [f32(3)], "Bias": [f32(3)]},
                      {"epsilon": 1e-5}),
    "group_norm": ("group_norm", {"X": [f32(2, 6, 3, 3)], "Scale": [f32(6)],
                                  "Bias": [f32(6)]},
                   {"groups": 3, "epsilon": 1e-5}),
    **{f"{op}": (op, {"X": [_X], "Y": [_Y]}, {})
       for op in ("equal", "greater_than", "greater_equal", "less_equal")},
    "logical_and": ("logical_and", {"X": [_BOOL_A], "Y": [_BOOL_B]}, {}),
    "logical_or": ("logical_or", {"X": [_BOOL_A], "Y": [_BOOL_B]}, {}),
    "logical_not": ("logical_not", {"X": [_BOOL_A]}, {}),
    "less_than_scalar": ("less_than_scalar", {"X": [_X]}, {"value": 0.25}),
}
_GRADS = ["prelu-all", "prelu-channel", "conv2d_transpose-stride2",
          "conv2d_transpose-groups2", "conv2d_transpose-pad4",
          "instance_norm", "group_norm"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_lowering(case):
    op_type, ins, attrs = CASES[case]
    _assert_same(_run_torch(op_type, ins, attrs), _run_jax(op_type, ins, attrs))


@pytest.mark.parametrize("case", _GRADS)
def test_grad_matches_jax_vjp(case):
    op_type, ins, attrs = CASES[case]
    gins, gattrs = _grad_op(op_type, ins, attrs)
    got = _run_torch(op_type + "_grad", gins, gattrs)
    assert got, op_type
    _assert_same(got, _run_jax(op_type + "_grad", gins, gattrs),
                 rtol=1e-5, atol=1e-5)


def test_conv2d_transpose_is_the_adjoint_of_conv2d():
    """<conv2d(y, w), x> == <y, conv2d_transpose(x, w)> at stride 2."""
    x, w, y = f32(1, 4, 3, 3), f32(4, 2, 3, 3), f32(1, 2, 7, 7)
    attrs = {"strides": [2, 2], "paddings": [0, 0], "groups": 1}
    up = _run_torch("conv2d_transpose", {"Input": [x], "Filter": [w]},
                    attrs)["Output"][0]
    down = torch.nn.functional.conv2d(torch.from_numpy(y), torch.from_numpy(w),
                                      stride=2).numpy()
    np.testing.assert_allclose((up * y).sum(), (down * x).sum(), rtol=1e-4)
