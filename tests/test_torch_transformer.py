"""The Transformer training program (``models/transformer.py``) in the
PyTorch port against the JAX package, in one process on the CPU, at a
tiny size (vocab 512, d 32, 4 heads, FFN 64, 1+1 layers, seq 8, batch 4,
no dropout):

* both builders emit the same program (op types, attributes, var names
  and shapes, in order) with Adam, with ``DGCMomentumOptimizer`` and with
  the default Noam-scheduled Adam, and the same startup program;
* with ``Adam(2e-3)``, as ``examples/machine_translation.py:27-30`` runs
  it, from the JAX startup's state carried by name: the 3-step loss
  stream within rtol 1e-5, atol 1e-6 (float32 sums in another order, about
  1e-7 relative); every parameter within atol 1e-5 after 3 steps (they
  move by up to 6e-3), except the attention key biases: softmax ignores a
  shift along the keys, so their grads are zero in exact arithmetic and
  hold rounding noise alone, which Adam scales to steps of up to the
  learning rate in either direction; they are held to 3 steps of it;
* the slice's new op types against the JAX lowerings, one case each
  (``CASES``, which ``tests/test_torch_ops.py`` counts toward its
  coverage of every ported op type): ``momentum`` (also Nesterov and L2
  decay), ``dgc_momentum``'s dense fused form and
  ``elementwise_sub``/``elementwise_min``/``square`` bit for bit;
  ``log_softmax`` and ``pow`` within rtol 1e-6, atol 1e-6 (exp, log and
  pow are computed by other routines in the two); the grads of the
  non-optimizer ops within rtol = atol = 1e-5, the training slice's bar;
* the Noam schedule's learning rate over its warm-up agrees within rtol
  1e-6. (Dropout is held against the JAX package in
  ``tests/test_torch_dropout.py``.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu.models import transformer as jax_tfm
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.models import transformer as torch_tfm
from paddle_tpu_torch.utils import unique_name as torch_names
from test_torch_train_ops import _assert_same, _grad_op, _run_jax, _run_torch

SEQ, BATCH, STEPS, LR = 8, 4, 3, 2e-3
CFG = dict(vocab_size=512, d_model=32, n_heads=4, d_ffn=64, n_enc_layers=1,
           n_dec_layers=1, max_len=16, dropout=0.0)


def _optimizer(pkg, kind):
    if kind == "adam":
        return pkg.optimizer.Adam(LR)
    if kind == "dgc":
        return pkg.optimizer.DGCMomentumOptimizer(
            0.01, 0.9, rampup_begin_step=1, rampup_step=2,
            sparsity=[0.996, 0.999])
    return None


def _build(mod, pkg, names, kind, **cfg):
    with names.guard():
        return mod.build_wmt_train(mod.TransformerConfig(**dict(CFG, **cfg)),
                                   src_len=SEQ, tgt_len=SEQ,
                                   optimizer=_optimizer(pkg, kind))


def _same_block(got, want):
    assert [op.desc() for op in got.ops] == [op.desc() for op in want.ops]
    # the JAX package runs int64 index vars as int32 (64-bit types off);
    # the port keeps int64, its torch index type
    wv = [v.desc() for v in want.vars.values()]
    for v in wv:
        if v["dtype"] == "int32":
            v["dtype"] = "int64"
    assert [v.desc() for v in got.vars.values()] == wv


@pytest.mark.parametrize("kind", ["adam", "dgc", "noam"])
def test_programs_match_the_jax_builder(kind):
    want = _build(jax_tfm, fluid, jax_names, kind)
    got = _build(torch_tfm, pt, torch_names, kind)
    for program in (0, 1):                   # main, startup
        _same_block(got[program].global_block(),
                    want[program].global_block())


def test_post_ln_program_matches():
    want = _build(jax_tfm, fluid, jax_names, "adam", pre_ln=False)[0]
    got = _build(torch_tfm, pt, torch_names, "adam", pre_ln=False)[0]
    _same_block(got.global_block(), want.global_block())


def test_adam_steps_match_jax():
    jmain, jstartup, _, jf = _build(jax_tfm, fluid, jax_names, "adam")
    tmain, tstartup, _, tf = _build(torch_tfm, pt, torch_names, "adam")
    batch = jax_tfm.synthetic_batch(np.random.RandomState(3), BATCH, SEQ, SEQ,
                                    jax_tfm.TransformerConfig(**CFG))
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None}
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    load_params(tscope, state)
    jl, tl = [], []
    for _ in range(STEPS):
        with fluid.scope_guard(jscope):
            jl.append(float(np.asarray(jexe.run(
                jmain, feed=batch, fetch_list=[jf[0].name])[0]).reshape(-1)[0]))
        tl.append(float(texe.run(tmain, feed=batch, fetch_list=[tf[0].name],
                                 scope=tscope)[0].reshape(-1)[0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert tl[-1] < tl[0]
    got = persistables_to_numpy(tscope, tmain)
    params = {p.name for p in tmain.all_parameters()}
    for name in params:
        want = np.asarray(jscope.find_var(name))
        atol = 3 * LR if ".k.b" in name else 1e-5
        np.testing.assert_allclose(got[name], want, rtol=0, atol=atol,
                                   err_msg=name)
        assert not np.array_equal(want, state[name]) or ".k.b" in name, name


def _ins(arrays, to):
    return {k: [to(v)] for k, v in arrays.items()}


@pytest.mark.parametrize("attrs", [
    {"mu": 0.9}, {"mu": 0.9, "use_nesterov": True},
    {"mu": 0.8, "regularization_method": "l2_decay",
     "regularization_coeff": 1e-3}], ids=["plain", "nesterov", "l2"])
def test_momentum_op_matches_jax_bit_for_bit(attrs):
    rng = np.random.RandomState(0)
    arrays = {"Param": rng.randn(33, 17).astype(np.float32),
              "Grad": rng.randn(33, 17).astype(np.float32),
              "Velocity": rng.randn(33, 17).astype(np.float32),
              "LearningRate": np.asarray([0.05], np.float32)}
    want = jax_op_def("momentum").lower(_ins(arrays, jnp.asarray), attrs)
    got = get_op_def("momentum").lower(_ins(arrays, torch.from_numpy), attrs)
    for slot in ("ParamOut", "VelocityOut"):
        np.testing.assert_array_equal(got[slot][0].numpy(),
                                      np.asarray(want[slot][0]), slot)


R = np.random.RandomState(12)


def _pos(*shape):
    return (R.rand(*shape).astype(np.float32) + 0.1) * 3


# op type -> (inputs, attrs): forward cases of the op types this slice adds
CASES = {
    "log_softmax": ({"X": [_pos(4, 7, 33)]}, {"axis": -1}),
    "elementwise_sub": ({"X": [_pos(4, 7, 33)], "Y": [_pos(33)]}, {"axis": -1}),
    "elementwise_min": ({"X": [_pos(4, 7, 33)], "Y": [_pos(33)]}, {"axis": -1}),
    "square": ({"X": [_pos(4, 33)]}, {}),
    "pow": ({"X": [_pos(4, 33)]}, {"factor": -0.5}),
    "momentum": ({"Param": [_pos(33, 17)], "Grad": [_pos(33, 17)],
                  "Velocity": [_pos(33, 17)],
                  "LearningRate": [np.asarray([0.05], np.float32)]},
                 {"mu": 0.9}),
    # the dense fused form (no DGC axis): the quantile selection
    "dgc_momentum": ({"Param": [_pos(40, 30)], "Grad": [_pos(40, 30)],
                      "U": [_pos(40, 30)], "V": [_pos(40, 30)],
                      "LearningRate": [np.asarray([0.1], np.float32)],
                      "CurrentStep": [np.asarray([3.0], np.float32)]},
                     {"mu": 0.9, "rampup_begin_step": 1.0,
                      "rampup_step": 4.0, "sparsity": [0.5, 0.9]}),
}
GRAD_CASES = {k: CASES[k] for k in ("log_softmax", "elementwise_sub",
                                    "elementwise_min", "square", "pow")}
# bit for bit: the same IEEE operations in the same order; exp, log and
# pow are computed by other routines in the two packages
EXACT = ("elementwise_sub", "elementwise_min", "square", "momentum",
         "dgc_momentum")


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_jax_lowering(op_type):
    ins, attrs = CASES[op_type]
    got = _run_torch(op_type, ins, attrs)
    want = _run_jax(op_type, ins, attrs)
    if op_type in EXACT:
        assert sorted(got) == sorted(want)
        for slot in want:
            np.testing.assert_array_equal(got[slot][0], want[slot][0], slot)
    else:
        _assert_same(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op_type", sorted(GRAD_CASES))
def test_grad_matches_jax_vjp(op_type):
    ins, attrs = GRAD_CASES[op_type]
    gins, gattrs = _grad_op(op_type, ins, attrs)
    got = _run_torch(op_type + "_grad", gins, gattrs)
    want = _run_jax(op_type + "_grad", gins, gattrs)
    assert got, op_type
    _assert_same(got, want, rtol=1e-5, atol=1e-5)


def test_noam_schedule_matches_jax():
    from paddle_tpu.layers import learning_rate_scheduler as jsched
    from paddle_tpu_torch.layers import learning_rate_scheduler as tsched

    def build(pkg, sched, names):
        main, startup = pkg.Program(), pkg.Program()
        with names.guard(), pkg.program_guard(main, startup):
            lr = pkg.layers.scale(sched.noam_decay(32, warmup_steps=4),
                                  scale=2.0)
        return main, startup, lr

    jmain, jstartup, jlr = build(fluid, jsched, jax_names)
    tmain, tstartup, tlr = build(pt, tsched, torch_names)
    _same_block(tmain.global_block(), jmain.global_block())
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        want = [float(np.asarray(jexe.run(jmain, fetch_list=[jlr.name])[0])
                      .reshape(-1)[0]) for _ in range(8)]
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    got = [float(texe.run(tmain, fetch_list=[tlr.name], scope=tscope)[0]
                 .reshape(-1)[0]) for _ in range(8)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the counter starts at 1 and ticks before the schedule reads it: the
    # runs see steps 2, 3, 4, ...; the rate peaks at step 4, the warm-up
    assert got.index(max(got)) == 2
