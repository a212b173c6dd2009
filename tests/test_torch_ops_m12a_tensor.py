"""The common tensor surface of the port (M12a) against the JAX package:
``ops/tensor.py``'s ``transpose``, ``flatten2``, ``split``, ``stack``,
``unstack``, ``strided_slice``, ``expand``, ``expand_as``, ``tile``,
``gather_nd``, ``scatter_nd_add``, ``index_select``, ``flip``, ``roll``,
``pad``, ``pad2d``, ``shape``, ``range``, ``linspace``, ``eye``,
``fill_constant_batch_size_like``, ``where_index``, ``isfinite`` and
``isfinite_v2``.

Forward within rtol 1e-5 / atol 1e-6, integers and bools exact (values:
index outputs are int64 in the port, int32 in the JAX package; ``shape``
is int32 in both); grads through ``jax.vjp`` and the port's generic grad
within 1e-5. The index inputs repeat rows, so the grads of ``gather_nd``
and ``index_select`` and the forward of ``scatter_nd_add`` sum
duplicates; ``strided_slice`` takes negative strides.
"""

import numpy as np
import pytest

from test_torch_train_ops import _assert_same, _grad_op, _run_jax, _run_torch

R = np.random.RandomState(31)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


def _scalar(v, dtype=np.float32):
    return np.array([v], dtype)


_DUP_ND = np.array([[1, 2], [0, 0], [1, 2], [2, 1]], np.int64)

# op type -> (inputs {slot: [np arrays]}, attrs)
CASES = {
    "transpose": ({"X": [f32(2, 3, 4)]}, {"axis": [2, 0, 1]}),
    "flatten2": ({"X": [f32(2, 3, 4, 5)]}, {"axis": 1}),
    "split": ({"X": [f32(2, 9, 3)]}, {"axis": 1, "num": 0,
                                      "sections": [2, 4, -1]}),
    "stack": ({"X": [f32(2, 3), f32(2, 3), f32(2, 3)]}, {"axis": 1}),
    "unstack": ({"X": [f32(3, 4, 2)]}, {"axis": 1, "num": 4}),
    "strided_slice": ({"Input": [f32(6, 7, 5)]},
                      {"axes": [0, 1, 2], "starts": [1, -1, 0],
                       "ends": [6, -8, 5], "strides": [2, -2, 3]}),
    "expand": ({"X": [f32(2, 1, 3)]}, {"expand_times": [2, 3, 1]}),
    "expand_as": ({"X": [f32(1, 3)], "target_tensor": [f32(4, 3)]}, {}),
    "tile": ({"X": [f32(2, 3)]}, {"repeat_times": [2, 1, 2]}),
    "gather_nd": ({"X": [f32(3, 4, 2)], "Index": [_DUP_ND]}, {}),
    "scatter_nd_add": ({"X": [f32(3, 4, 2)], "Index": [_DUP_ND],
                        "Updates": [f32(4, 2)]}, {}),
    "index_select": ({"X": [f32(3, 5)],
                      "Index": [np.array([4, 0, 4, 2, 4], np.int64)]},
                     {"dim": 1}),
    "flip": ({"X": [f32(2, 3, 4)]}, {"axis": [0, 2]}),
    "roll": ({"X": [f32(3, 4)]}, {"shifts": [1, -2], "axis": [0, 1]}),
    "pad": ({"X": [f32(2, 3)]}, {"paddings": [1, 0, 2, 3], "pad_value": 0.5}),
    "pad2d": ({"X": [f32(1, 2, 4, 5)]}, {"paddings": [1, 2, 0, 3],
                                         "mode": "reflect"}),
    "shape": ({"Input": [f32(2, 3, 4)]}, {}),
    "range": ({"Start": [_scalar(0.1)], "End": [_scalar(1.0)],
               "Step": [_scalar(0.1)]}, {}),
    # 0-d bounds: the JAX lowering's float() refuses the [1]-shaped ones
    # its own layer makes (jax 0.9; test_linspace_takes_its_layers_bounds)
    "linspace": ({"Start": [np.float32(0.3)], "Stop": [np.float32(1.7)],
                  "Num": [np.int32(7)]}, {}),
    "eye": ({}, {"num_rows": 3, "num_columns": 5, "dtype": "float32"}),
    "fill_constant_batch_size_like": (
        {"Input": [f32(5, 2)]},
        {"shape": [-1, 3], "dtype": "float32", "value": 1.5,
         "input_dim_idx": 0, "output_dim_idx": 0}),
    "where_index": ({"Condition": [np.array([[True, False, True],
                                             [False, False, True]])]}, {}),
    "isfinite": ({"X": [np.array([1.0, np.inf, 0.0], np.float32)]}, {}),
    "isfinite_v2": ({"X": [np.array([1.0, np.inf, -np.inf, np.nan],
                                    np.float32)]}, {}),
}

# further attributes of the same op types: case -> (op type, ins, attrs)
VARIANTS = {
    "split_num": ("split", {"X": [f32(2, 6)]}, {"axis": -1, "num": 3}),
    "strided_slice_empty": ("strided_slice", {"Input": [f32(5, 4)]},
                            {"axes": [0], "starts": [1], "ends": [1],
                             "strides": [-1]}),
    "strided_slice_reverse_all": ("strided_slice", {"Input": [f32(5, 4)]},
                                  {"axes": [0], "starts": [-1],
                                   "ends": [-6], "strides": [-1]}),
    "expand_rank_up": ("expand", {"X": [f32(3)]}, {"expand_times": [2, 2]}),
    "gather_nd_full": ("gather_nd", {"X": [f32(3, 4)],
                                     "Index": [np.array([[[0, 1], [2, 3]],
                                                         [[0, 1], [1, 1]]],
                                                        np.int64)]}, {}),
    "pad2d_constant": ("pad2d", {"X": [f32(1, 2, 3, 3)]},
                       {"paddings": [0, 1, 2, 0], "mode": "constant",
                        "pad_value": -1.0}),
    "pad2d_edge": ("pad2d", {"X": [f32(2, 1, 3, 4)]},
                   {"paddings": [2, 0, 1, 1], "mode": "edge"}),
    "range_int": ("range", {"Start": [_scalar(2, np.int64)],
                            "End": [_scalar(11, np.int64)],
                            "Step": [_scalar(3, np.int64)]}, {}),
    "range_negative": ("range", {"Start": [_scalar(1.0)], "End": [_scalar(-2.0)],
                                 "Step": [_scalar(-0.75)]}, {}),
    "eye_square_int": ("eye", {}, {"num_rows": 4, "dtype": "int64"}),
    "fill_constant_batch_size_like_dim1": (
        "fill_constant_batch_size_like", {"Input": [f32(2, 7)]},
        {"shape": [4, -1], "dtype": "int64", "value": 3,
         "input_dim_idx": 1, "output_dim_idx": 1}),
    "isfinite_all": ("isfinite", {"X": [f32(2, 3)]}, {}),
}

ALL = dict({t: (t,) + CASES[t] for t in CASES}, **VARIANTS)
# every input index/bound/condition (nondiff_inputs) or none at all
NO_GRAD = ("shape", "range", "where_index", "isfinite", "isfinite_v2")
# linspace's JAX lowering reads its bounds with float(): jax.vjp cannot
# trace it, so only its forward is compared; eye has no input
GRAD_CASES = {c: v for c, v in ALL.items()
              if v[0] not in NO_GRAD + ("linspace", "eye")
              and "int" not in c}


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


def test_duplicate_indices_sum():
    """``scatter_nd_add`` adds both updates aimed at ``[1, 2]``; the grad
    of ``gather_nd`` / ``index_select`` adds the cotangents of every row
    that read the same element."""
    ins, attrs = CASES["scatter_nd_add"]
    out = _run_torch("scatter_nd_add", ins, attrs)["Out"][0]
    x, upd = ins["X"][0], ins["Updates"][0]
    np.testing.assert_allclose(out[1, 2], x[1, 2] + upd[0] + upd[2], rtol=1e-6)
    ins, attrs = CASES["index_select"]
    gins, gattrs = _grad_op("index_select", ins, attrs)
    gins["Out@GRAD"] = [np.ones((3, 5), np.float32)]
    g = _run_torch("index_select_grad", gins, gattrs)["X@GRAD"][0]
    np.testing.assert_array_equal(g[0], [1, 0, 1, 0, 3])


def test_shape_is_int32_and_host_read_ops_follow_their_inputs():
    ins, attrs = CASES["shape"]
    out = _run_torch("shape", ins, attrs)["Out"][0]
    assert out.dtype == np.int32 and out.tolist() == [2, 3, 4]
    ins, attrs = VARIANTS["range_int"][1:]
    out = _run_torch("range", ins, attrs)["Out"][0]
    assert out.dtype == np.int64 and out.tolist() == [2, 5, 8]
    ins, attrs = CASES["where_index"]
    out = _run_torch("where_index", ins, attrs)["Out"][0]
    assert out.tolist() == [[0, 0], [0, 2], [1, 2]]


def test_linspace_takes_its_layers_bounds():
    """``layers.linspace`` feeds its op ``[1]``-shaped bounds
    (``fill_constant([1], ...)``), which the port reads on the host; the
    JAX lowering's ``float()`` refuses a 1-element array under this
    container's jax (ROADMAP queue C), so the values are held against
    the 0-d run of the JAX op."""
    ins = {"Start": [_scalar(0.3)], "Stop": [_scalar(1.7)],
           "Num": [_scalar(7, np.int32)]}
    got = _run_torch("linspace", ins, {})["Out"][0]
    want = _run_jax("linspace", *CASES["linspace"])["Out"][0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
