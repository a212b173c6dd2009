"""The ops of ``ops/nn_extra.py`` in the port (M12a) against the JAX
package: ``selu``, ``brelu``, ``soft_relu``, ``stanh``, ``argsort``,
``diag``, ``reverse``, ``rank``, ``size``, ``crop_tensor``,
``log_loss``, ``label_smooth`` and ``adaptive_pool2d``.

Forward within rtol 1e-5 / atol 1e-6, integers exact (values: the
port's index outputs are int64, the JAX package's int32); grads through
``jax.vjp`` and the port's generic grad within 1e-5. The kinks of the
JAX formulas are inputs: 0 for ``selu``, the clip ends of ``brelu`` and
``soft_relu``; so are tied values for ``argsort`` (stable, also
descending) and for ``adaptive_pool2d``'s max.
"""

import numpy as np
import pytest

from test_torch_train_ops import _assert_same, _grad_op, _run_jax, _run_torch

R = np.random.RandomState(41)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


def _kinks(*points):
    """Random values with the given points planted in the first row."""
    x = f32(3, 8) * 4
    x[0, :len(points)] = points
    return {"X": [x]}


_SORT = np.array([[2.0, -1.0, 2.0, 0.5, -1.0, 2.0],
                  [0.0, 0.0, 3.0, -3.0, 0.0, 1.0]], np.float32)
_POOL = f32(2, 3, 6, 4)
_POOL[0, 0, :3, :2] = 1.25   # a tied maximum in one cell

# op type -> (inputs {slot: [np arrays]}, attrs)
CASES = {
    "selu": (_kinks(0.0, -1.0, 1.0), {}),
    "brelu": (_kinks(0.0, 24.0, -1.0, 25.0), {"t_min": 0.0, "t_max": 24.0}),
    "soft_relu": (_kinks(-4.0, 4.0, 0.0, 5.0), {"threshold": 4.0}),
    "stanh": (_kinks(0.0), {"scale_a": 0.67, "scale_b": 1.7159}),
    "argsort": ({"X": [_SORT]}, {"axis": -1, "descending": False}),
    "diag": ({"Diagonal": [f32(4)]}, {}),
    "reverse": ({"X": [f32(2, 3, 4)]}, {"axis": [0, 2]}),
    "rank": ({"Input": [f32(2, 3, 4)]}, {}),
    "size": ({"Input": [f32(2, 3, 4)]}, {}),
    "crop_tensor": ({"X": [f32(4, 5, 6)]},
                    {"offsets": [1, 0, 2], "shape": [2, 5, 3]}),
    "log_loss": ({"Predicted": [R.uniform(0.05, 0.95, (5, 1)).astype(np.float32)],
                  "Labels": [np.array([[1], [0], [1], [1], [0]], np.float32)]},
                 {"epsilon": 1e-4}),
    "label_smooth": ({"X": [np.eye(4, dtype=np.float32)[[1, 3, 0]]]},
                     {"epsilon": 0.1}),
    "adaptive_pool2d": ({"X": [_POOL]}, {"pooled_height": 2, "pooled_width": 2,
                                         "pooling_type": "max"}),
}

# further attributes of the same op types: case -> (op type, ins, attrs)
VARIANTS = {
    "argsort_descending": ("argsort", {"X": [_SORT]},
                           {"axis": -1, "descending": True}),
    "argsort_axis0": ("argsort", {"X": [_SORT.T.copy()]},
                      {"axis": 0, "descending": True}),
    "diag_matrix": ("diag", {"Diagonal": [f32(3, 3)]}, {}),
    "label_smooth_prior": ("label_smooth",
                           {"X": [np.eye(4, dtype=np.float32)[[1, 3]]],
                            "PriorDist": [np.array([[0.1, 0.2, 0.3, 0.4]],
                                                   np.float32)]},
                           {"epsilon": 0.2}),
    "adaptive_pool2d_avg": ("adaptive_pool2d", {"X": [f32(2, 3, 6, 4)]},
                            {"pooled_height": 3, "pooled_width": 1,
                             "pooling_type": "avg"}),
    "adaptive_pool2d_global": ("adaptive_pool2d", {"X": [f32(2, 5, 7, 7)]},
                               {"pooled_height": 1, "pooled_width": 1,
                                "pooling_type": "avg"}),
}

ALL = dict({t: (t,) + CASES[t] for t in CASES}, **VARIANTS)
NO_GRAD = ("argsort", "rank", "size")
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


def test_brelu_clip_ends_split_the_grad():
    """``jnp.clip`` at either end of ``brelu`` gives half the cotangent,
    in both packages."""
    ins = {"X": [np.array([0.0, 24.0, 12.0], np.float32)]}
    gins, gattrs = _grad_op("brelu", ins, {})
    gins["Out@GRAD"] = [np.ones(3, np.float32)]
    for run in (_run_torch, _run_jax):
        np.testing.assert_array_equal(
            run("brelu_grad", gins, gattrs)["X@GRAD"][0], [0.5, 0.5, 1.0])


def test_argsort_is_stable_both_ways():
    """Ties keep ascending index order, ascending and descending (the
    JAX lowering sorts ``-x`` for descending)."""
    got = _run_torch("argsort", {"X": [_SORT]}, {"descending": True})
    np.testing.assert_array_equal(got["Indices"][0][0], [0, 2, 5, 3, 1, 4])
    got = _run_torch("argsort", {"X": [_SORT]}, {"descending": False})
    np.testing.assert_array_equal(got["Indices"][0][1], [3, 0, 1, 4, 5, 2])


def test_adaptive_pool2d_refuses_uneven_cells_as_jax_does():
    from paddle_tpu.utils.enforce import EnforceError as JaxEnforceError
    from paddle_tpu_torch.utils.enforce import EnforceError

    attrs = {"pooled_height": 4, "pooled_width": 1, "pooling_type": "avg"}
    ins = {"X": [f32(1, 2, 6, 4)]}
    with pytest.raises(EnforceError, match="adaptive_pool2d needs H"):
        _run_torch("adaptive_pool2d", ins, attrs)
    with pytest.raises(JaxEnforceError, match="adaptive_pool2d needs H"):
        _run_jax("adaptive_pool2d", ins, attrs)
