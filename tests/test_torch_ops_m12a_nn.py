"""The common neural-net surface of the port (M12a) against the JAX
package: ``ops/nn.py``'s activations, ``one_hot``, ``huber_loss``,
``smooth_l1_loss``, ``kldiv_loss`` and ``depthwise_conv2d``
(``ops/nn_extra.py``'s ops: ``test_torch_ops_m12a_nn_extra.py``).

Forward within rtol 1e-5 / atol 1e-6, integers exact (values: the
port's index outputs are int64, the JAX package's int32); grads through
``jax.vjp`` and the port's generic grad within 1e-5. Every kink of the
JAX formulas is an input: 0 for ``relu6``, ``leaky_relu``, ``elu``,
``softsign`` and ``softplus``; the threshold 6 of ``relu6``; the clip
ends of ``hard_sigmoid`` and ``hard_swish``; ``|d| = delta`` and 0 for
the two robust losses; ids outside ``[0, depth)`` for ``one_hot``.
"""

import numpy as np
import pytest

from test_torch_train_ops import _assert_same, _grad_op, _run_jax, _run_torch

R = np.random.RandomState(29)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


def _kinks(*points):
    """Random values with the given points planted in the first row."""
    x = f32(3, 8) * 4
    x[0, :len(points)] = points
    return {"X": [x]}


# op type -> (inputs {slot: [np arrays]}, attrs)
CASES = {
    "relu6": (_kinks(0.0, 6.0, -1.0, 7.0, 3.0), {"threshold": 6.0}),
    "leaky_relu": (_kinks(0.0, -2.0, 2.0), {"alpha": 0.1}),
    "elu": (_kinks(0.0, -2.0, 2.0), {"alpha": 0.5}),
    "softplus": (_kinks(0.0, 30.0, -30.0), {}),
    "softsign": (_kinks(0.0), {}),
    "silu": (_kinks(0.0), {}),
    "swish": (_kinks(0.0), {"beta": 1.5}),
    "mish": (_kinks(0.0), {}),
    # slope 0.25, offset 0.5: -2 and 2 land exactly on the clip ends
    "hard_sigmoid": (_kinks(-2.0, 2.0, 0.0), {"slope": 0.25, "offset": 0.5}),
    "hard_swish": (_kinks(-3.0, 3.0, 0.0),
                   {"offset": 3.0, "threshold": 6.0, "scale": 6.0}),
    "one_hot": ({"X": [np.array([[2], [0], [-1], [5], [4]], np.int64)]},
                {"depth": 5}),
    "huber_loss": ({"X": [np.array([[0.0], [1.0], [0.5], [-2.0], [3.0]],
                                   np.float32)],
                    "Y": [np.array([[0.0], [0.0], [-0.5], [1.0], [0.25]],
                                   np.float32)]}, {"delta": 1.0}),
    "smooth_l1_loss": ({"X": [np.array([[[0.0, 1.0], [0.25, -3.0]],
                                        [[2.0, 0.5], [-0.5, 0.1]]], np.float32)],
                        "Y": [np.array([[[0.0, 0.0], [0.0, 0.0]],
                                        [[1.0, 0.0], [0.0, 1.0]]], np.float32)]},
                       {"sigma": 1.0}),
    "kldiv_loss": ({"X": [f32(3, 4)],
                    "Target": [np.abs(f32(3, 4)) * np.array([1, 0, 1, 1],
                                                            np.float32)]},
                   {"reduction": "mean"}),
    "depthwise_conv2d": ({"Input": [f32(2, 4, 7, 7)], "Filter": [f32(4, 1, 3, 3)]},
                         {"strides": [2, 2], "paddings": [1, 1],
                          "dilations": [1, 1], "groups": 1,
                          "data_format": "NCHW"}),
}

# further attributes of the same op types: case -> (op type, ins, attrs)
VARIANTS = {
    "relu6_default": ("relu6", _kinks(0.0, 6.0), {}),
    "leaky_relu_default": ("leaky_relu", _kinks(0.0, -1.0), {}),
    "hard_sigmoid_default": ("hard_sigmoid", _kinks(0.0, 2.5, -2.5), {}),
    "hard_swish_default": ("hard_swish", _kinks(-3.0, 3.0), {}),
    "huber_loss_delta": ("huber_loss", {"X": [f32(6, 1)], "Y": [f32(6, 1)]},
                         {"delta": 0.5}),
    "smooth_l1_loss_sigma": ("smooth_l1_loss", {"X": [f32(4, 3)],
                                                "Y": [f32(4, 3)]},
                             {"sigma": 2.0}),
    "kldiv_loss_sum": ("kldiv_loss", {"X": [f32(3, 4)],
                                      "Target": [np.abs(f32(3, 4))]},
                       {"reduction": "sum"}),
    "kldiv_loss_batchmean": ("kldiv_loss", {"X": [f32(3, 4)],
                                            "Target": [np.abs(f32(3, 4))]},
                             {"reduction": "batchmean"}),
    "kldiv_loss_none": ("kldiv_loss", {"X": [f32(3, 4)],
                                       "Target": [np.abs(f32(3, 4))]},
                        {"reduction": "none"}),
    "depthwise_conv2d_same": ("depthwise_conv2d",
                              {"Input": [f32(1, 3, 6, 6)],
                               "Filter": [f32(3, 1, 3, 3)]},
                              {"strides": [1, 1], "paddings": [0, 0],
                               "padding_algorithm": "SAME",
                               "dilations": [1, 1]}),
}

ALL = dict({t: (t,) + CASES[t] for t in CASES}, **VARIANTS)
NO_GRAD = ("one_hot",)
GRAD_CASES = {c: v for c, v in ALL.items() if v[0] not in NO_GRAD}


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
    fwd = _run_jax(op_type, ins, attrs)
    gins = dict(ins, **fwd)
    gattrs = dict(attrs, __fwd_inputs__=list(ins), __fwd_outputs__=list(fwd))
    assert _run_torch(op_type + "_grad", gins, gattrs) == {}
    assert _run_jax(op_type + "_grad", gins, gattrs) == {}


@pytest.mark.parametrize("op_type, x, want", [
    # relu6 = minimum(relu(x), 6): relu's grad at 0 is 0, the tie at 6
    # splits
    ("relu6", [0.0, 6.0, 3.0, 7.0], [0.0, 0.5, 1.0, 0.0]),
    # where(x >= 0, x, alpha x): 1 at 0
    ("leaky_relu", [0.0, -1.0], [1.0, 0.02]),
    # the expm1 branch at 0: alpha exp(0)
    ("elu", [0.0, 1.0], [1.0, 1.0]),
    # clip(0.2 x + 0.5, 0, 1) at -2.5 and 2.5: half the slope
    ("hard_sigmoid", [-2.5, 2.5, 0.0], [0.1, 0.1, 0.2]),
])
def test_kink_grads_are_the_jax_formulas(op_type, x, want):
    """The grad of each activation at its kinks, with cotangent 1, equal
    to the JAX package's and to the value its formula gives."""
    ins = {"X": [np.array(x, np.float32)]}
    gins, gattrs = _grad_op(op_type, ins, {})
    gins["Out@GRAD"] = [np.ones(len(x), np.float32)]
    for run in (_run_torch, _run_jax):
        np.testing.assert_allclose(run(op_type + "_grad", gins, gattrs)
                                   ["X@GRAD"][0], want, rtol=1e-6,
                                   err_msg=f"{op_type} {run.__name__}")


def test_one_hot_out_of_range_rows_are_zero():
    ins, attrs = CASES["one_hot"]
    out = _run_torch("one_hot", ins, attrs)["Out"][0]
    assert out.dtype == np.float32 and out.shape == (5, 5)
    np.testing.assert_array_equal(out.sum(1), [1, 1, 0, 0, 1])
