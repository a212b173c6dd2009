"""The common math surface of the port (M12a) against the JAX package:
``ops/math.py``'s unary ops, reductions, ``arg_max`` / ``arg_min``,
``cumsum`` and ``elementwise_pow`` / ``mod`` / ``floordiv``;
``ops/misc_extra.py``'s ``fill_any_like``, ``reduce_all`` / ``any``,
``squeeze``, ``flatten``, ``unsqueeze`` and ``unique`` /
``unique_with_counts``; ``ops/extras.py``'s ``hinge_loss``.

Forward: the same numpy inputs through both lowerings, within rtol 1e-5 /
atol 1e-6; integer and boolean results exact (values: the port's index
outputs are int64 where the JAX package's are int32). Grads: the same
inputs and cotangents through ``jax.vjp`` and the port's generic grad
(``resolve_op_def``), within 1e-5. The inputs hold the kinks and ties the
JAX formulas decide: tied maxima and minima (the grad is split evenly),
tied arg_max/arg_min (the first index wins), a zero in a product, halves
for ``round`` (to even), negative operands of ``mod`` / ``floordiv``
(the divisor's sign; floor), a hinge margin of exactly 0 (split), and
``unique``'s tail (X's last element, counts 0).
"""

import numpy as np
import pytest

from test_torch_train_ops import _assert_same, _grad_op, _run_jax, _run_torch

R = np.random.RandomState(23)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


def pos(*shape):
    return (np.abs(R.randn(*shape)) + 0.2).astype(np.float32)


_TIES = np.array([[1.5, -2.0, 1.5, 0.0], [3.0, 3.0, -1.0, -1.0],
                  [0.25, 0.25, 0.25, 0.25]], np.float32)
_HALVES = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -0.51], np.float32)
_NEG = np.array([[-7.0, 7.0, -7.5, 7.5], [-6.0, 0.0, 5.25, -0.25]], np.float32)
_DIV = np.array([[3.0, -3.0, 2.0, -2.0], [3.0, 4.0, -1.5, 0.5]], np.float32)
_IDS = np.array([3, 1, 3, 0, 1, 7, 7, 2], np.int64)


def _unary(x):
    return ({"X": [x]}, {})


# op type -> (inputs {slot: [np arrays]}, attrs)
CASES = {
    "abs": _unary(np.array([[-1.5, 0.0, 2.0], [0.5, -0.25, 0.0]], np.float32)),
    "ceil": _unary(_HALVES),
    "floor": _unary(_HALVES),
    "round": _unary(_HALVES),
    "cos": _unary(f32(3, 4)),
    "sin": _unary(f32(3, 4)),
    "exp": _unary(f32(3, 4)),
    "log": _unary(pos(3, 4)),
    "log1p": _unary(pos(3, 4) - 0.5),
    "log2": _unary(pos(3, 4)),
    "sqrt": _unary(pos(3, 4)),
    "rsqrt": _unary(pos(3, 4)),
    "reciprocal": _unary(pos(3, 4) * np.sign(f32(3, 4))),
    "erf": _unary(f32(3, 4)),
    "reduce_mean": ({"X": [f32(2, 3, 4)]},
                    {"dim": [1, 2], "keep_dim": False, "reduce_all": False}),
    "reduce_max": ({"X": [_TIES]}, {"dim": [1], "keep_dim": True,
                                    "reduce_all": False}),
    "reduce_min": ({"X": [_TIES]}, {"dim": [1], "keep_dim": False,
                                    "reduce_all": False}),
    "reduce_prod": ({"X": [np.array([[1.5, -2.0, 0.5], [0.0, 3.0, 2.0]],
                                    np.float32)]},
                    {"dim": [1], "keep_dim": False, "reduce_all": False}),
    "arg_max": ({"X": [_TIES]}, {"axis": 1}),
    "arg_min": ({"X": [_TIES]}, {"axis": -1}),
    "cumsum": ({"X": [f32(3, 5)]}, {"axis": 1}),
    "elementwise_pow": ({"X": [pos(2, 3, 4)], "Y": [f32(3, 4)]}, {"axis": -1}),
    "elementwise_mod": ({"X": [_NEG], "Y": [_DIV]}, {"axis": -1}),
    "elementwise_floordiv": ({"X": [_NEG], "Y": [_DIV]}, {"axis": -1}),
    "fill_any_like": ({"X": [f32(2, 3)]}, {"value": 2.5}),
    "reduce_all": ({"X": [np.array([[True, True, False], [True, True, True]])]},
                   {"dim": [1], "keep_dim": False, "reduce_all": False}),
    "reduce_any": ({"X": [np.array([[False, False, False], [False, True, False]])]},
                   {"dim": [1], "keep_dim": True, "reduce_all": False}),
    "squeeze": ({"X": [f32(3, 1, 4, 1)]}, {"axes": [1]}),
    "flatten": ({"X": [f32(2, 3, 4, 5)]}, {"axis": 2}),
    "unsqueeze": ({"X": [f32(3, 4)]}, {"axes": [0, 3]}),
    "unique": ({"X": [_IDS]}, {"dtype": "int32"}),
    "unique_with_counts": ({"X": [_IDS]}, {"dtype": "int32"}),
    # labels 1 at logit 1 and labels 0 at logit -1: margins of exactly 0
    "hinge_loss": ({"Logits": [np.array([[1.0], [-1.0], [0.3], [-2.0]],
                                        np.float32)],
                    "Labels": [np.array([[1.0], [0.0], [1.0], [1.0]],
                                        np.float32)]}, {}),
}

# further attributes of the same op types: case -> (op type, ins, attrs)
VARIANTS = {
    "reduce_mean_all": ("reduce_mean", {"X": [f32(2, 3)]},
                        {"dim": [0], "keep_dim": False, "reduce_all": True}),
    "reduce_max_all_ties": ("reduce_max", {"X": [_TIES]},
                            {"dim": [0], "keep_dim": False, "reduce_all": True}),
    "reduce_min_axis0": ("reduce_min", {"X": [_TIES]},
                         {"dim": [0], "keep_dim": False, "reduce_all": False}),
    "reduce_prod_all": ("reduce_prod", {"X": [pos(2, 3)]},
                        {"dim": [0], "keep_dim": True, "reduce_all": True}),
    "arg_max_axis0": ("arg_max", {"X": [_TIES]}, {"axis": 0}),
    "cumsum_reverse": ("cumsum", {"X": [f32(3, 5)]}, {"axis": 1, "reverse": True}),
    "cumsum_exclusive": ("cumsum", {"X": [f32(3, 5)]},
                         {"axis": 0, "exclusive": True}),
    "cumsum_reverse_exclusive": ("cumsum", {"X": [f32(3, 5)]},
                                 {"axis": -1, "reverse": True, "exclusive": True}),
    "cumsum_int": ("cumsum", {"X": [np.array([[3, -1, 4], [1, 5, -9]], np.int32)]},
                   {"axis": 1}),
    "elementwise_pow_axis": ("elementwise_pow", {"X": [pos(2, 3, 4)],
                                                 "Y": [f32(3)]}, {"axis": 1}),
    "elementwise_mod_int": ("elementwise_mod",
                            {"X": [np.array([-7, 7, -8, 9], np.int32)],
                             "Y": [np.array([3, -3, 3, -4], np.int32)]}, {}),
    "elementwise_floordiv_int": ("elementwise_floordiv",
                                 {"X": [np.array([-7, 7, -8, 9], np.int32)],
                                  "Y": [np.array([3, -3, 3, -4], np.int32)]}, {}),
    "reduce_all_all": ("reduce_all", {"X": [np.ones((2, 3), bool)]},
                       {"dim": [0], "keep_dim": False, "reduce_all": True}),
    "reduce_any_all": ("reduce_any", {"X": [np.zeros((2, 3), bool)]},
                       {"dim": [0], "keep_dim": False, "reduce_all": True}),
    "squeeze_all": ("squeeze", {"X": [f32(3, 1, 4, 1)]}, {"axes": []}),
    "flatten_axis0": ("flatten", {"X": [f32(2, 3, 4)]}, {"axis": 0}),
    "unique_float": ("unique", {"X": [np.array([0.5, -1.0, 0.5, 2.0, 2.0],
                                               np.float32)]}, {}),
    "unique_with_counts_int64": ("unique_with_counts", {"X": [_IDS[::-1].copy()]},
                                 {"dtype": "int64"}),
}

ALL = dict({t: (t,) + CASES[t] for t in CASES}, **VARIANTS)

# the forward cases whose op has a grad (float inputs outside
# nondiff_inputs); ``abs`` away from 0 (its grad at 0: below)
GRAD_CASES = {c: v for c, v in ALL.items() if v[0] not in (
    "arg_max", "arg_min", "reduce_all", "reduce_any", "unique",
    "unique_with_counts") and not c.endswith("_int") and c != "abs"}
GRAD_CASES["abs"] = ("abs", {"X": [np.array([[-1.5, 0.25, 2.0]], np.float32)]},
                     {})
# ops whose grad is empty in both packages: every input is nondiff
NO_GRAD = ("arg_max", "arg_min", "reduce_all", "reduce_any", "unique",
           "unique_with_counts")


@pytest.mark.parametrize("case", sorted(ALL))
def test_op_matches_jax_lowering(case):
    op_type, ins, attrs = ALL[case]
    _assert_same(_run_torch(op_type, ins, attrs), _run_jax(op_type, ins, attrs))


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grad_matches_jax_vjp(case):
    op_type, ins, attrs = GRAD_CASES[case]
    gins, gattrs = _grad_op(op_type, ins, attrs)
    got = _run_torch(op_type + "_grad", gins, gattrs)
    assert got, case
    _assert_same(got, _run_jax(op_type + "_grad", gins, gattrs),
                 rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op_type", NO_GRAD)
def test_ops_of_index_inputs_have_no_grad_in_either_package(op_type):
    ins, attrs = CASES[op_type]
    if op_type in ("arg_max", "arg_min"):
        gins, gattrs = _grad_op(op_type, ins, attrs)
    else:
        fwd = _run_jax(op_type, ins, attrs)
        gins = dict(ins, **fwd)
        gattrs = dict(attrs, __fwd_inputs__=list(ins), __fwd_outputs__=list(fwd))
    assert _run_torch(op_type + "_grad", gins, gattrs) == {}
    assert _run_jax(op_type + "_grad", gins, gattrs) == {}


def test_tied_extremes_split_the_grad_evenly():
    """Row ``[3, 3, -1, -1]``: ``reduce_max`` sends half the cotangent to
    each 3 and ``reduce_min`` half to each -1, in both packages."""
    for op_type, want in (("reduce_max", [0.5, 0.5, 0, 0]),
                          ("reduce_min", [0, 0, 0.5, 0.5])):
        ins, attrs = CASES[op_type]
        gins, gattrs = _grad_op(op_type, ins, attrs)
        gins["Out@GRAD"] = [np.ones_like(gins["Out"][0])]
        for run in (_run_torch, _run_jax):
            g = run(op_type + "_grad", gins, gattrs)["X@GRAD"][0]
            np.testing.assert_array_equal(g[1], want, err_msg=op_type)
            np.testing.assert_array_equal(g[2], [0.25] * 4, err_msg=op_type)


def test_arg_max_and_arg_min_take_the_first_of_ties():
    for op_type, want in (("arg_max", [0, 0, 0]), ("arg_min", [1, 2, 0])):
        ins, attrs = CASES[op_type]
        np.testing.assert_array_equal(_run_torch(op_type, ins, attrs)["Out"][0],
                                      want)


def test_mod_and_floordiv_follow_the_divisor_and_floor():
    ins, attrs = CASES["elementwise_mod"]
    np.testing.assert_array_equal(
        _run_torch("elementwise_mod", ins, attrs)["Out"][0][0], [2, -2, 0.5, -0.5])
    np.testing.assert_array_equal(
        _run_torch("elementwise_floordiv", ins, attrs)["Out"][0][0],
        [-3, -3, -4, -4])


def test_abs_grad_at_zero_is_zero_where_the_jax_package_gives_one():
    """The reference's AbsGradFunctor is ``dout * sign(x)``: 0 at 0. The
    JAX lowering's ``jnp.abs`` has grad 1 there (ROADMAP queue C); the
    port gives 0, and both agree everywhere else."""
    ins, attrs = CASES["abs"]
    gins, gattrs = _grad_op("abs", ins, attrs)
    gins["Out@GRAD"] = [np.ones_like(ins["X"][0])]
    got = _run_torch("abs_grad", gins, gattrs)["X@GRAD"][0]
    want = _run_jax("abs_grad", gins, gattrs)["X@GRAD"][0]
    zero = ins["X"][0] == 0
    np.testing.assert_array_equal(got[zero], 0.0)
    np.testing.assert_array_equal(want[zero], 1.0)
    np.testing.assert_array_equal(got[~zero], want[~zero])


def test_hinge_margin_of_zero_splits_its_grad():
    ins, attrs = CASES["hinge_loss"]
    gins, gattrs = _grad_op("hinge_loss", ins, attrs)
    gins["Loss@GRAD"] = [np.ones((4, 1), np.float32)]
    got = _run_torch("hinge_loss_grad", gins, gattrs)["Logits@GRAD"][0]
    np.testing.assert_array_equal(got[:2, 0], [-0.5, 0.5])


def test_unique_fills_its_tail_with_the_last_element():
    """``jnp.unique(size=len(x), fill_value=x[-1])``: the sorted uniques,
    then X's last element (2 here, not the last unique, 7); int32 index
    and counts by default, counts 0 in the tail."""
    ins, attrs = CASES["unique_with_counts"]
    got = _run_torch("unique_with_counts", ins, attrs)
    np.testing.assert_array_equal(got["Out"][0], [0, 1, 2, 3, 7, 2, 2, 2])
    np.testing.assert_array_equal(got["Index"][0], [3, 1, 3, 0, 1, 4, 4, 2])
    np.testing.assert_array_equal(got["Count"][0], [1, 2, 1, 2, 2, 0, 0, 0])
    assert got["Index"][0].dtype == np.int32


def test_clip_ends_split_the_grad_as_jax_does():
    """``clip`` (BERT's path) is ``jnp.clip`` in the JAX package: an
    element on either end gives half its cotangent to X. The port's
    lowering is the same ``maximum``/``minimum`` pair (``ops/common.py``
    ``jnp_clip``; it was ``torch.clamp``, which gives X all of it)."""
    ins = {"X": [np.array([-0.5, 0.7, 0.1, 2.0], np.float32)]}
    attrs = {"min": -0.5, "max": 0.7}
    gins, gattrs = _grad_op("clip", ins, attrs)
    gins["Out@GRAD"] = [np.ones(4, np.float32)]
    for run in (_run_torch, _run_jax):
        np.testing.assert_array_equal(
            run("clip_grad", gins, gattrs)["X@GRAD"][0], [0.5, 0.5, 1.0, 0.0])
