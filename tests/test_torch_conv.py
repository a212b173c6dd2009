"""The conv-net slice's op lowerings and their grads, port against the JAX
package, op by op, and the weight-decay programs.

Forward: the same numpy inputs go through the JAX package's lowering and
the port's. Grads: the same inputs and random output cotangents go
through each package's ``<type>_grad`` (``jax.vjp`` in the JAX package,
``torch.autograd`` over the forward lowering in the port). Cases:

* ``conv2d``: stride 1 and 2, explicit, SAME (asymmetric on an odd
  total), VALID and 4-element padding, dilation 2, groups 2, NCHW/OIHW
  and NHWC/HWIO;
* ``pool2d``: max and avg, exclusive and not with padding, SAME, global,
  adaptive, NHWC;
* ``batch_norm``: training (NCHW and NHWC), ``is_test`` and
  ``use_global_stats``, every output (``MeanOut``, ``VarianceOut``,
  ``SavedMean``, ``SavedVariance`` included); its grad from ``Y@GRAD``;
* ``cross_entropy`` (hard labels with ``ignore_index``, soft labels),
  ``square_error_cost``, ``top_k``, ``accuracy`` and ``sign``.

Inputs are standard normal draws, so no max-pool window and no top-k row
holds a tie (the two packages route a tied max's grad, and order tied
values, differently). Float results agree within rtol 1e-5, atol 1e-6,
grads within rtol = atol = 1e-5 (float32 sums in another order); integer
results and every shape exactly.

Weight decay: ``Momentum`` with ``L2Decay`` on every parameter, one of
them carrying its own ``ParamAttr(regularizer=L1Decay)``, emits the same
program in both packages (``scale``/``sign``/``sum`` ops, names, attrs);
from the same weights two steps give the same losses (rtol 1e-5) and
parameters (atol 1e-6). With ``grad_clip=`` the clip ops come first, as
in the JAX package.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.utils import unique_name as torch_names
from test_torch_train_ops import _assert_same, _run_jax, _run_torch

R = np.random.RandomState(23)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


def _conv(x, w, **attrs):
    attrs.setdefault("strides", [1, 1])
    attrs.setdefault("paddings", [0, 0])
    attrs.setdefault("dilations", [1, 1])
    attrs.setdefault("groups", 1)
    attrs.setdefault("data_format", "NCHW")
    return {"Input": [x], "Filter": [w]}, attrs


def _pool(x, **attrs):
    return {"X": [x]}, attrs


def _bn(x, channels, **attrs):
    attrs.setdefault("momentum", 0.9)
    attrs.setdefault("epsilon", 1e-5)
    return ({"X": [x], "Scale": [f32(channels)], "Bias": [f32(channels)],
             "Mean": [f32(channels)],
             "Variance": [np.abs(f32(channels)) + 0.5]}, attrs)


_PROBS = np.exp(f32(4, 5))
_PROBS /= _PROBS.sum(-1, keepdims=True)
_SOFT = np.abs(f32(4, 5))
_SOFT /= _SOFT.sum(-1, keepdims=True)

# op type -> {case id: (inputs {slot: [np arrays]}, attrs)}
CASES = {
    "conv2d": {
        "stride1_explicit": _conv(f32(2, 3, 7, 6), f32(4, 3, 3, 3),
                                  paddings=[1, 1]),
        "stride2": _conv(f32(2, 3, 7, 6), f32(4, 3, 3, 3), strides=[2, 2],
                         paddings=[1, 1]),
        "same_odd": _conv(f32(2, 3, 7, 6), f32(4, 3, 3, 3), strides=[2, 2],
                          padding_algorithm="SAME"),
        "valid": _conv(f32(2, 3, 7, 6), f32(4, 3, 3, 3), paddings=[2, 2],
                       padding_algorithm="VALID"),
        "pad4": _conv(f32(2, 3, 7, 6), f32(4, 3, 3, 2),
                      paddings=[0, 1, 2, 0]),
        "dilation2": _conv(f32(2, 3, 9, 8), f32(4, 3, 3, 3), paddings=[2, 2],
                           dilations=[2, 2]),
        "groups2": _conv(f32(2, 4, 7, 6), f32(6, 2, 3, 3), paddings=[1, 1],
                         groups=2),
        "nhwc": _conv(f32(2, 7, 6, 3), f32(3, 3, 3, 4), strides=[2, 1],
                      paddings=[1, 0], data_format="NHWC"),
        "stem_7x7": _conv(f32(1, 3, 16, 16), f32(8, 3, 7, 7), strides=[2, 2],
                          paddings=[3, 3]),
    },
    "pool2d": {
        "max_3x3_s2_pad1": _pool(f32(2, 3, 9, 8), pooling_type="max",
                                 ksize=[3, 3], strides=[2, 2],
                                 paddings=[1, 1]),
        "max_2x2": _pool(f32(2, 3, 8, 6), pooling_type="max", ksize=[2, 2],
                         strides=[2, 2], paddings=[0, 0]),
        "max_same_odd": _pool(f32(2, 3, 7, 6), pooling_type="max",
                              ksize=[3, 3], strides=[2, 2],
                              padding_algorithm="SAME"),
        "avg_exclusive_pad1": _pool(f32(2, 3, 9, 8), pooling_type="avg",
                                    ksize=[3, 3], strides=[2, 2],
                                    paddings=[1, 1], exclusive=True),
        "avg_inclusive_pad1": _pool(f32(2, 3, 9, 8), pooling_type="avg",
                                    ksize=[3, 3], strides=[2, 2],
                                    paddings=[1, 1], exclusive=False),
        "avg_exclusive_pad4": _pool(f32(2, 3, 7, 6), pooling_type="avg",
                                    ksize=[3, 2], strides=[2, 2],
                                    paddings=[2, 0, 1, 1], exclusive=True),
        "avg_2x2": _pool(f32(2, 3, 8, 6), pooling_type="avg", ksize=[2, 2],
                         strides=[2, 2], paddings=[0, 0]),
        "global_max": _pool(f32(2, 3, 5, 4), pooling_type="max",
                            global_pooling=True),
        "global_avg": _pool(f32(2, 3, 5, 4), pooling_type="avg",
                            global_pooling=True),
        "adaptive_avg_2x3": _pool(f32(2, 3, 6, 9), pooling_type="avg",
                                  ksize=[2, 3], adaptive=True),
        "adaptive_max_3x2": _pool(f32(2, 3, 6, 4), pooling_type="max",
                                  ksize=[3, 2], adaptive=True),
        "adaptive_avg_1x1": _pool(f32(2, 3, 5, 4), pooling_type="avg",
                                  ksize=[1, 1], adaptive=True),
        "nhwc_avg": _pool(f32(2, 8, 6, 3), pooling_type="avg", ksize=[2, 2],
                          strides=[2, 2], paddings=[1, 1],
                          data_format="NHWC"),
    },
    "batch_norm": {
        "train": _bn(f32(4, 3, 5, 6) * 2 + 1, 3),
        "train_nhwc": _bn(f32(4, 5, 6, 3) * 2 + 1, 3, data_layout="NHWC"),
        "train_2d": _bn(f32(6, 4), 4),
        "is_test": _bn(f32(4, 3, 5, 6), 3, is_test=True),
        "use_global_stats": _bn(f32(4, 3, 5, 6), 3, use_global_stats=True),
    },
    "cross_entropy": {
        "hard": ({"X": [_PROBS], "Label": [np.array([[1], [4], [0], [2]],
                                                    np.int64)]},
                 {"soft_label": False, "ignore_index": -100}),
        "ignore_index": ({"X": [_PROBS],
                          "Label": [np.array([[1], [-100], [3], [-100]],
                                             np.int64)]},
                         {"soft_label": False, "ignore_index": -100}),
        "soft": ({"X": [_PROBS], "Label": [_SOFT]},
                 {"soft_label": True, "ignore_index": -100}),
    },
    "square_error_cost": {
        "column": ({"X": [f32(5, 1)], "Y": [f32(5, 1)]}, {}),
    },
    "top_k": {
        "k1": ({"X": [f32(4, 7)]}, {"k": 1}),
        "k3": ({"X": [f32(2, 3, 7)]}, {"k": 3}),
    },
    "accuracy": {
        "top2": ({"Out": [f32(6, 2)],
                  "Indices": [np.array([[1, 2], [0, 3], [4, 1], [2, 0],
                                        [3, 3], [1, 0]], np.int64)],
                  "Label": [np.array([[2], [1], [4], [9], [3], [0]],
                                     np.int64)]}, {}),
        "label_1d": ({"Out": [f32(3, 1)],
                      "Indices": [np.array([[1], [0], [2]], np.int64)],
                      "Label": [np.array([1, 1, 2], np.int64)]}, {}),
    },
    "sign": {
        "with_zeros": ({"X": [np.array([[-2.0, 0.0, 3.5], [0.0, -0.1, 1e-30]],
                                       np.float32)]}, {}),
    },
}

_FORWARD = [(t, c) for t, cases in sorted(CASES.items()) for c in cases]
_GRAD = [(t, c) for t, c in _FORWARD if t not in ("accuracy", "sign")]


@pytest.mark.parametrize("op_type,case", _FORWARD,
                         ids=[f"{t}-{c}" for t, c in _FORWARD])
def test_op_matches_jax_lowering(op_type, case):
    ins, attrs = CASES[op_type][case]
    _assert_same(_run_torch(op_type, ins, attrs),
                 _run_jax(op_type, ins, attrs))


def _grad_op(op_type, ins, attrs):
    """``<op_type>_grad``'s inputs as ``append_backward`` emits them:
    forward ins and outs, random cotangents for the float outputs a loss
    reaches (batch_norm's ``Y`` only: its other outputs are running or
    saved statistics, stop_gradient)."""
    fwd = _run_jax(op_type, ins, attrs)
    rng = np.random.RandomState(5)
    gins = dict(ins)
    for slot, vals in fwd.items():
        gins[slot] = vals
        if op_type == "batch_norm" and slot != "Y":
            continue
        if all(np.issubdtype(v.dtype, np.floating) for v in vals):
            gins[slot + "@GRAD"] = [rng.randn(*v.shape).astype(np.float32)
                                    for v in vals]
    return gins, dict(attrs, __fwd_inputs__=list(ins),
                      __fwd_outputs__=list(fwd))


@pytest.mark.parametrize("op_type,case", _GRAD,
                         ids=[f"{t}-{c}" for t, c in _GRAD])
def test_grad_matches_jax_vjp(op_type, case):
    gins, gattrs = _grad_op(op_type, *CASES[op_type][case])
    got = _run_torch(op_type + "_grad", gins, gattrs)
    assert got, op_type
    _assert_same(got, _run_jax(op_type + "_grad", gins, gattrs),
                 rtol=1e-5, atol=1e-5)


def test_batch_norm_follows_paddle_not_torch_conventions():
    """The running variance takes the BIASED batch variance, the momentum
    weights the old statistic, SavedVariance is the inverse std."""
    ins, attrs = CASES["batch_norm"]["train"]
    out = _run_torch("batch_norm", ins, attrs)
    x = ins["X"][0].astype(np.float64)
    batch_var = x.var(axis=(0, 2, 3))                      # biased
    np.testing.assert_allclose(
        out["VarianceOut"][0], 0.9 * ins["Variance"][0] + 0.1 * batch_var,
        rtol=1e-5)
    np.testing.assert_allclose(
        out["MeanOut"][0], 0.9 * ins["Mean"][0] + 0.1 * x.mean(axis=(0, 2, 3)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["SavedVariance"][0],
                               1 / np.sqrt(batch_var + 1e-5), rtol=1e-5)


def test_batch_norm_grad_rerun_leaves_running_stats_alone():
    """The grad op's rerun forward writes no output but the grads, so the
    running statistics are updated once a step."""
    gins, gattrs = _grad_op("batch_norm", *CASES["batch_norm"]["train"])
    got = _run_torch("batch_norm_grad", gins, gattrs)
    assert sorted(got) == ["Bias@GRAD", "Scale@GRAD", "X@GRAD"]


# -- weight decay ------------------------------------------------------------


def _decay_program(mod, names, grad_clip=None):
    with names.guard():
        main, startup = mod.Program(), mod.Program()
        with mod.program_guard(main, startup):
            x = mod.data("x", shape=[-1, 6])
            y = mod.data("y", shape=[-1, 1])
            h = mod.layers.fc(x, size=5, act="relu", param_attr=mod.ParamAttr(
                name="l1_w", regularizer=mod.regularizer.L1Decay(0.01)))
            pred = mod.layers.fc(h, size=1)
            loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
            mod.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9,
                regularization=mod.regularizer.L2Decay(0.05),
                grad_clip=grad_clip).minimize(loss)
    return main, startup, loss


def test_weight_decay_programs_match_the_jax_builder():
    jmain = _decay_program(fluid, jax_names)[0]
    tmain = _decay_program(pt, torch_names)[0]
    want = [op.desc() for op in jmain.global_block().ops]
    assert [op.desc() for op in tmain.global_block().ops] == want
    types = [op["type"] for op in want]
    # L1 on the parameter that asks for it, L2 on the other three
    assert types.count("sign") == 1 and types.count("scale") == 4
    sign = next(op for op in tmain.global_block().ops if op.type == "sign")
    assert sign.input("X") == ["l1_w"]


def test_weight_decay_steps_match_jax():
    jmain, jstartup, jloss = _decay_program(fluid, jax_names)
    tmain, tstartup, tloss = _decay_program(pt, torch_names)
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(8, 6).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32)}
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {p.name: np.asarray(jscope.find_var(p.name))
                 for p in jmain.all_parameters()}
        jl = [jexe.run(jmain, feed=feed, fetch_list=[jloss.name])[0]
              for _ in range(2)]
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    load_params(tscope, state)
    tl = [texe.run(tmain, feed=feed, fetch_list=[tloss.name], scope=tscope)[0]
          for _ in range(2)]
    np.testing.assert_allclose(np.concatenate(tl), np.concatenate(jl),
                               rtol=1e-5)
    for name in state:
        got = tscope.find_var(name).numpy()
        np.testing.assert_allclose(got, np.asarray(jscope.find_var(name)),
                                   atol=1e-6, err_msg=name)
        assert not np.array_equal(got, state[name]), name


def test_grad_clip_still_raises_naming_m1b():
    """``grad_clip=`` no longer raises (M1b landed): the clip comes before
    the weight decay, in the same program as the JAX package's."""
    jmain = _decay_program(fluid, jax_names,
                           fluid.clip.GradientClipByNorm(0.5))[0]
    tmain = _decay_program(pt, torch_names,
                           pt.clip.GradientClipByNorm(0.5))[0]
    want = [op.desc() for op in jmain.global_block().ops]
    assert [op.desc() for op in tmain.global_block().ops] == want
    types = [op["type"] for op in want]
    assert types.count("clip_by_norm") == 4
    assert max(i for i, t in enumerate(types) if t == "clip_by_norm") < \
        types.index("sign")
