"""The training slice's op lowerings and their grads, port against the JAX
package, one parametrised case per op type.

Forward: the same numpy inputs go through
``paddle_tpu.core.registry.OpRegistry.get(t).lower`` and the port's
lowering (its ``kernel`` lowering where it has one: on CPU tensors that
is the kernel's plain version). Grads: the same inputs and random output
cotangents go through each package's ``<t>_grad`` lowering from
``resolve_op_def`` — ``jax.vjp`` in the JAX package, ``torch.autograd``
over the forward lowering in the port.

Float results agree within rtol = 1e-5 and atol = 1e-6, grads within
rtol = atol = 1e-5 (float32 sums in another order); integer and boolean
results and every shape agree exactly. Index tensors stay int64 in the port where the JAX package runs
them as int32, so only values are compared. A stateful op gets the same
key in both (``PRNGKey(0)``), so ``truncated_gaussian_random`` gives
``jax.random``'s values: it is held equal, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch  # noqa: F401  (registers the port's lowerings)
from paddle_tpu.core.backward import resolve_op_def as jax_resolve
from paddle_tpu_torch.core.backward import resolve_op_def as torch_resolve

R = np.random.RandomState(11)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


def i64(*values):
    return np.array(values, np.int64)


_LABELS = np.array([[[3], [-1], [6]], [[-1], [0], [2]]], np.int64)
_BIAS = np.where(R.rand(2, 6) > 0.3, 0.0, -1e4).astype(np.float32)
_BIAS[:, 0] = 0.0   # no row fully masked, causal or not

# op type -> (inputs {slot: [np arrays]}, attrs): forward cases of the op
# types this slice adds
CASES = {
    "layer_norm": ({"X": [f32(2, 3, 8)], "Scale": [f32(8)], "Bias": [f32(8)]},
                   {"begin_norm_axis": 2, "epsilon": 1e-5}),
    "transpose2": ({"X": [f32(2, 3, 4, 5)]}, {"axis": [0, 2, 1, 3]}),
    "scaled_dot_product_attention": (
        {"Q": [f32(2, 3, 6, 4)], "K": [f32(2, 3, 6, 4)], "V": [f32(2, 3, 6, 4)],
         "Bias": [_BIAS]}, {"causal": False, "sm_scale": 0.5}),
    "gelu": ({"X": [f32(3, 5) * 2]}, {}),
    "tanh": ({"X": [f32(3, 5)]}, {}),
    "slice": ({"Input": [f32(2, 5, 4)]}, {"axes": [1], "starts": [1], "ends": [4]}),
    "batched_gather": ({"X": [f32(2, 6, 3)],
                        "Index": [np.array([[5, 0, 5, 2], [1, 1, 4, 3]], np.int64)]},
                       {}),
    "softmax_with_cross_entropy": ({"Logits": [f32(2, 3, 7) * 3], "Label": [_LABELS]},
                                   {"soft_label": False, "ignore_index": -1,
                                    "axis": -1}),
    "cast": ({"X": [np.array([[1, 0, 1]], np.int64)]}, {"out_dtype": "float32"}),
    "scale": ({"X": [f32(3, 4)]}, {"scale": 3.0, "bias": -2.0,
                                   "bias_after_scale": False}),
    "not_equal": ({"X": [np.array([[3, -1, 5]], np.int64)], "Y": [i64(-1)]}, {}),
    "less_than": ({"X": [np.array([4.0], np.float32)],
                   "Y": [np.array([10000.0], np.float32)]}, {}),
    "reduce_sum": ({"X": [f32(2, 3, 4)]}, {"dim": [1], "keep_dim": False,
                                           "reduce_all": False}),
    "elementwise_max": ({"X": [f32(2, 3)], "Y": [f32(3)]}, {"axis": -1}),
    "elementwise_div": ({"X": [f32(2, 3)], "Y": [np.abs(f32(2, 3)) + 0.5]},
                        {"axis": -1}),
    "mean": ({"X": [f32(4, 5)]}, {}),
    "clip": ({"X": [f32(3, 4)]}, {"min": -0.5, "max": 0.7}),
    "where": ({"Condition": [np.array([True, False, True])], "X": [f32(3)],
               "Y": [f32(3)]}, {}),
    "sum": ({"X": [f32(2, 3), f32(2, 3), f32(2, 3)]}, {}),
    "assign_value": ({}, {"shape": [1, 4], "dtype": "int64",
                          "values": [0, 1, 2, 3]}),
    "increment": ({"X": [np.array([2.0], np.float32)]}, {"step": 1.0}),
    "fill_zeros_like": ({"X": [f32(2, 3)]}, {}),
    "adam": ({"Param": [f32(4, 3)], "Grad": [f32(4, 3)],
              "Moment1": [f32(4, 3) * 0.1], "Moment2": [np.abs(f32(4, 3)) * 0.1],
              "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
              "Beta2Pow": [np.array([0.999 ** 3], np.float32)],
              "LearningRate": [np.array([1e-2], np.float32)]},
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "truncated_gaussian_random": ({}, {"shape": [200, 50], "dtype": "float32",
                                       "mean": 0.0, "std": 0.02, "seed": 0}),
}

# grads of every ``*_grad`` type of the BERT pretraining program, plus the
# float ops around its loss and learning rate
GRAD_CASES = dict(
    {t: CASES[t] for t in (
        "layer_norm", "transpose2", "scaled_dot_product_attention", "gelu",
        "tanh", "slice", "batched_gather", "softmax_with_cross_entropy",
        "scale", "reduce_sum", "elementwise_max", "elementwise_div", "mean",
        "clip", "where", "sum")},
    lookup_table_v2=({"W": [f32(10, 4)], "Ids": [i64(1, 2, 9, 2, 0)]},
                     {"padding_idx": -1}),
    elementwise_add=({"X": [f32(2, 3, 4)], "Y": [f32(3)]}, {"axis": 1}),
    mul=({"X": [f32(2, 3, 4)], "Y": [f32(4, 5)]},
         {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    reshape2=({"X": [f32(2, 6)]}, {"shape": [0, 3, -1]}),
)
GRAD_CASES["scaled_dot_product_attention_causal"] = (
    GRAD_CASES["scaled_dot_product_attention"][0], {"causal": True})


def _run_jax(op_type, ins, attrs):
    jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    if jax_resolve(op_type).stateful:
        jins["__rng_key__"] = [jax.random.PRNGKey(0)]
    out = jax_resolve(op_type).lower(jins, dict(attrs))
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


def _run_torch(op_type, ins, attrs):
    op_def = torch_resolve(op_type)
    tins = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    if op_def.stateful:
        tins["__rng_key__"] = [(0, 0)]       # jax.random.PRNGKey(0)
    if op_def.creates:
        tins["__device__"] = [torch.device("cpu")]
    out = op_def.lowering()(tins, dict(attrs))
    return {k: [t.numpy() for t in v] for k, v in out.items()}


def _assert_same(got, want, rtol=1e-5, atol=1e-6):
    assert sorted(got) == sorted(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if slot == "XShape":
                continue            # a shape record: only its shape matters
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(g, w, err_msg=slot)


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_jax_lowering(op_type):
    ins, attrs = CASES[op_type]
    got = _run_torch(op_type, ins, attrs)
    if op_type == "truncated_gaussian_random":
        (out,) = got["Out"]
        std = attrs["std"]
        assert out.shape == tuple(attrs["shape"]) and out.dtype == np.float32
        assert out.min() >= -2 * std and out.max() <= 2 * std
        np.testing.assert_array_equal(out, _run_jax(op_type, ins, attrs)["Out"][0])
        return
    _assert_same(got, _run_jax(op_type, ins, attrs))


def test_adam_two_updates_match_jax():
    ins, attrs = CASES["adam"]
    state = {k: [np.array(a) for a in v] for k, v in ins.items()}
    jstate = {k: [np.array(a) for a in v] for k, v in ins.items()}
    for step in range(2):
        got = _run_torch("adam", state, attrs)
        want = _run_jax("adam", jstate, attrs)
        _assert_same(got, want)
        for slot in ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"):
            state[slot] = got[slot + "Out"]
            jstate[slot] = want[slot + "Out"]
        state["Grad"] = jstate["Grad"] = [f32(4, 3)]
    assert not np.array_equal(state["Param"][0], ins["Param"][0])


def _grad_op(op_type, ins, attrs):
    """The inputs and attrs of ``<op_type>_grad`` as ``append_backward``
    emits them: forward ins and outs, random cotangents for the float
    outputs the loss reaches (not XShape, Mean/Variance or Softmax)."""
    fwd = _run_jax(op_type, ins, attrs)
    rng = np.random.RandomState(5)
    gins = dict(ins)
    for slot, vals in fwd.items():
        gins[slot] = vals
        if slot in ("XShape", "Mean", "Variance", "Softmax"):
            continue
        if all(np.issubdtype(v.dtype, np.floating) for v in vals):
            gins[slot + "@GRAD"] = [rng.randn(*v.shape).astype(np.float32)
                                    for v in vals]
    gattrs = dict(attrs, __fwd_inputs__=list(ins), __fwd_outputs__=list(fwd))
    return gins, gattrs


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grad_matches_jax_vjp(case):
    op_type = case.replace("_causal", "")
    ins, attrs = GRAD_CASES[case]
    gins, gattrs = _grad_op(op_type, ins, attrs)
    got = _run_torch(op_type + "_grad", gins, gattrs)
    want = _run_jax(op_type + "_grad", gins, gattrs)
    assert got, op_type
    _assert_same(got, want, rtol=1e-5, atol=1e-5)


def test_ignored_labels_get_zero_loss_and_zero_grad():
    ins, attrs = CASES["softmax_with_cross_entropy"]
    gins, gattrs = _grad_op("softmax_with_cross_entropy", ins, attrs)
    loss = _run_torch("softmax_with_cross_entropy", ins, attrs)["Loss"][0]
    grad = _run_torch("softmax_with_cross_entropy_grad", gins,
                      gattrs)["Logits@GRAD"][0]
    ignored = _LABELS[..., 0] == -1
    assert (loss[ignored] == 0).all() and (loss[~ignored] > 0).all()
    assert (grad[ignored] == 0).all() and (np.abs(grad[~ignored]) > 0).any()


def test_register_grad_replaces_the_generic_grad(monkeypatch):
    from paddle_tpu_torch.core import backward, registry

    monkeypatch.setattr(backward, "_GRAD_DEF_CACHE", {})
    monkeypatch.setattr(registry.OpRegistry.get("tanh"), "grad", None)
    ins, attrs = CASES["tanh"]
    gins, gattrs = _grad_op("tanh", ins, attrs)
    generic = _run_torch("tanh_grad", gins, gattrs)["X@GRAD"][0]

    @registry.register_grad("tanh")
    def _tanh_grad(ins, attrs):
        out, dout = ins["Out"][0], ins["Out@GRAD"][0]
        return {"X@GRAD": [dout * (1 - out * out)]}

    backward._GRAD_DEF_CACHE.clear()
    assert torch_resolve("tanh_grad").lower is _tanh_grad
    np.testing.assert_allclose(_run_torch("tanh_grad", gins, gattrs)["X@GRAD"][0],
                               generic, rtol=1e-5, atol=1e-6)
