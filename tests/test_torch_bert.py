"""BERT pretraining in the PyTorch port against the JAX package, at a tiny
size on the CPU (``BertConfig.tiny()``: vocab 1024, hidden 64, 2 layers,
4 heads; dropout 0, flash attention on, seq 32, batch 4):

* both packages' ``build_bert_pretrain`` emit the same ops (types,
  attributes, var names, in order) and vars, for P = None and P = 5, with
  flash attention and unfused;
* every persistable of the JAX program after its startup run (parameters,
  Adam moments and beta powers, the learning-rate step counter) carries
  into the port by name, and ``persistables_to_numpy`` reads the port's
  whole training state back out;
* with that state, its step counter set to the end of the warmup so that
  every step applies the full learning rate (1e-3), one step gives every
  ``param@GRAD`` within rtol 1e-4, atol 1e-6; the loss stream of 3 steps
  agrees within rtol 1e-4, atol 1e-5 (the bar of
  ``test_bert_flash_matches_unfused``); after 3 steps every persistable
  agrees: parameters within atol 1e-6 (they move by about 3e-3), Adam's
  first moments within rtol 1e-4, atol 1e-7 (the grads' bar on a weighted
  sum of grads with weights adding up to 0.271), second moments within
  rtol 2e-4, atol 1e-12 (the square of a grad at rtol 1e-4; the values
  reach about 1e-4), beta powers within rtol 1e-6 and the step counter
  exactly. The JAX side runs its Pallas flash-attention kernels in
  interpret mode; the port's flash attention runs its plain versions (CPU
  tensors). Float32 sums run in another order in the two;
* the unfused path's first step agrees at the same bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import kernels as jax_kernels
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch import kernels
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.utils import unique_name as torch_names

SEQ, BATCH, STEPS, P = 32, 4, 3, 5
LR = 1e-3
# build_bert_pretrain warms the learning rate up from 0 over 10000 steps;
# a counter loaded at 10000 makes every step apply the full LR
WARMED_UP = 10000.0
COUNTER = "@LR_DECAY_COUNTER@"


def _cfg(mod, flash=True):
    cfg = mod.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    cfg.use_flash_attention = flash
    return cfg


def _build(mod, names, P, flash=True):
    with names.guard():
        return mod.build_bert_pretrain(_cfg(mod, flash), seq_len=SEQ, lr=LR,
                                       max_predictions_per_seq=P)


@pytest.mark.parametrize("program", [0, 1], ids=["main", "startup"])
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "unfused"])
@pytest.mark.parametrize("P", [None, 5])
def test_programs_match_the_jax_builder(P, flash, program):
    want = _build(jax_bert, jax_names, P, flash)[program].global_block()
    got = _build(torch_bert, torch_names, P, flash)[program].global_block()
    assert [op.desc() for op in got.ops] == [op.desc() for op in want.ops]
    # the JAX package runs int64 index vars as int32 (64-bit types off);
    # the port keeps int64, its torch index type
    wv = [v.desc() for v in want.vars.values()]
    for v in wv:
        if v["dtype"] == "int32":
            v["dtype"] = "int64"
    assert [v.desc() for v in got.vars.values()] == wv


def test_builder_refuses_what_the_port_does_not_run():
    # the flash path applies no attention-prob dropout: refused, as the
    # JAX builder refuses it
    cfg = _cfg(torch_bert)
    cfg.attention_probs_dropout_prob = 0.1
    with pytest.raises(pt.EnforceError, match="attention_probs_dropout_prob"):
        torch_bert.build_bert_pretrain(cfg, seq_len=SEQ)


@pytest.fixture(scope="module")
def runs():
    """The JAX program and the port's from one starting state: the JAX
    startup's persistables, with the step counter past the warmup, loaded
    into the port by name. Each runs STEPS steps on one batch, fetching the
    loss every step and every ``param@GRAD`` at the first."""
    jmain, jstartup, _, jfetch = _build(jax_bert, jax_names, P)
    tmain, tstartup, _, tfetch = _build(torch_bert, torch_names, P)
    batch = jax_bert.synthetic_batch(np.random.RandomState(5), BATCH, SEQ,
                                     _cfg(jax_bert), P)
    params = [p.name for p in tmain.all_parameters()]
    grads = [p + "@GRAD" for p in params]

    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
    jscope.set(COUNTER, jnp.full([1], WARMED_UP, jnp.float32))
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None}
    jrun = []
    with fluid.scope_guard(jscope), jax_kernels.scoped_mode("interpret"):
        for step in range(STEPS):
            jrun.append(jexe.run(jmain, feed=batch, fetch_list=[jfetch[0].name]
                                 + (grads if step == 0 else [])))
    jstate = {n: np.asarray(jscope.find_var(n)) for n in state}

    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    load_params(tscope, state)
    loaded = persistables_to_numpy(tscope, tmain)
    kernels.reset_launches()
    trun = [texe.run(tmain, feed=batch, fetch_list=[tfetch[0].name]
                     + (grads if step == 0 else []), scope=tscope)
            for step in range(STEPS)]
    assert all(n == 0 for n in kernels.launches().values())
    return dict(state=state, loaded=loaded, params=params, grads=grads,
                jrun=jrun, trun=trun, jstate=jstate,
                tstate=persistables_to_numpy(tscope, tmain), tmain=tmain,
                tstartup=tstartup, batch=batch, tfetch=tfetch)


def test_jax_persistables_carry_over_by_name(runs):
    state, loaded = runs["state"], runs["loaded"]
    names = set(state)
    assert names == set(loaded)
    assert {COUNTER, "word_embedding_moment1_0",
            "word_embedding_beta2_pow_acc_0"} <= names
    # 3 embeddings, the embedding norm, 16 per layer, 5 head layers; Adam
    # keeps 4 accumulators per parameter, plus the step counter
    assert len(runs["params"]) == 3 + 2 + 16 * 2 + 10 == 47
    assert len(names) == 47 * 5 + 1
    for n, a in state.items():
        np.testing.assert_array_equal(loaded[n], a, err_msg=n)


def test_one_step_param_grads_match_jax(runs):
    jgrads, tgrads = runs["jrun"][0][1:], runs["trun"][0][1:]
    assert len(tgrads) == len(runs["grads"]) == 47
    for name, g, w in zip(runs["grads"], tgrads, jgrads):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
    assert np.abs(tgrads[runs["grads"].index("word_embedding@GRAD")]).max() > 0


def test_loss_stream_matches_jax(runs):
    want = [float(r[0][0]) for r in runs["jrun"]]
    got = [float(r[0][0]) for r in runs["trun"]]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_params_after_three_steps_match_jax(runs):
    """Every persistable after 3 full-LR steps: parameters, Adam's moments
    and beta powers, and the step counter."""
    got, want, start = runs["tstate"], runs["jstate"], runs["state"]
    assert set(got) == set(want) == set(start)
    for n in runs["params"]:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-6,
                                   err_msg=n)
        # each parameter moves by about LR a step, far beyond the bar; the
        # key projections' biases alone do not, since softmax ignores them
        # and their grads hold rounding noise
        moved = np.abs(got[n] - start[n]).max()
        assert moved > 2 * LR or n.endswith("attn.k.b"), (n, moved)
    bars = {"_moment1_": (1e-4, 1e-7), "_moment2_": (2e-4, 1e-12),
            "_beta1_pow_acc_": (1e-6, 0), "_beta2_pow_acc_": (1e-6, 0)}
    for n in set(got) - set(runs["params"]) - {COUNTER}:
        (rtol, atol), = [b for key, b in bars.items() if key in n]
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=atol,
                                   err_msg=n)
        assert not np.array_equal(got[n], start[n]), n
    np.testing.assert_array_equal(got[COUNTER], [WARMED_UP + STEPS])
    np.testing.assert_array_equal(want[COUNTER], [WARMED_UP + STEPS])


def test_snapshot_restores_the_whole_training_state(runs):
    """``persistables_to_numpy`` -> ``load_params`` into a fresh scope
    brings back moments, beta powers and the step counter: the restored
    program repeats the first step's loss and counter exactly."""
    tmain, tstartup = runs["tmain"], runs["tstartup"]
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(tstartup, scope=scope)
    load_params(scope, runs["loaded"])
    first = exe.run(tmain, feed=runs["batch"], fetch_list=[runs["tfetch"][0]],
                    scope=scope)[0]
    snap = persistables_to_numpy(scope, tmain)
    assert snap[COUNTER][0] == WARMED_UP + 1
    second = exe.run(tmain, feed=runs["batch"], fetch_list=[runs["tfetch"][0]],
                     scope=scope)[0]
    again = pt.Scope()
    exe.run(tstartup, scope=again)
    load_params(again, snap)
    replay = exe.run(tmain, feed=runs["batch"], fetch_list=[runs["tfetch"][0]],
                     scope=again)[0]
    np.testing.assert_array_equal(replay, second)
    assert float(first[0]) == float(runs["trun"][0][0][0])
    assert isinstance(again.find_var(COUNTER), torch.Tensor)


def test_unfused_attention_step_matches_jax():
    """The unfused path (matmul, softmax and their generic grads in place
    of the flash op): one step from the JAX startup state gives the same
    loss and grads as the JAX package's."""
    jmain, jstartup, _, jfetch = _build(jax_bert, jax_names, None, flash=False)
    tmain, tstartup, _, tfetch = _build(torch_bert, torch_names, None,
                                        flash=False)
    batch = jax_bert.synthetic_batch(np.random.RandomState(6), BATCH, SEQ,
                                     _cfg(jax_bert), None)
    grads = [p.name + "@GRAD" for p in tmain.all_parameters()]
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        load_params(tscope, {n: np.asarray(jscope.find_var(n))
                             for n in persistables_to_numpy(tscope, tmain)})
        want = jexe.run(jmain, feed=batch, fetch_list=[jfetch[0].name] + grads)
    got = texe.run(tmain, feed=batch, fetch_list=[tfetch[0].name] + grads,
                   scope=tscope)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    for name, g, w in zip(grads, got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)


# -- bf16 AMP -----------------------------------------------------------------
# The bench recipe (bench.py:106-133) under ``use_amp=True``: flash, hidden
# dropout 0.1. XLA may keep a bf16 value in float32 across a fused round
# trip where eager torch rounds it (``xla_allow_excess_precision``), and
# the plain 16-bit flash versions round P against the row's maximum where
# the Pallas kernel takes its blocks', so the packages are not bit-equal;
# over 3 full-LR steps their losses part by 1.6e-5 relative at most (on
# this test's batch). The bar, 2e-4, leaves ten times that.
AMP_LOSS_RTOL = 2e-4


def _amp_cfg(mod, flash):
    cfg = _cfg(mod, flash)
    cfg.hidden_dropout_prob = 0.1
    return cfg


def _build_amp(mod, names, flash=True, P=P):
    with names.guard():
        return mod.build_bert_pretrain(_amp_cfg(mod, flash), seq_len=SEQ, lr=LR,
                                       max_predictions_per_seq=P, use_amp=True)


@pytest.mark.parametrize("program", [0, 1], ids=["main", "startup"])
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "unfused"])
def test_amp_programs_match_the_jax_builder(flash, program):
    """The AMP rewrite, op for op: the same casts (``<var>.cast_bfloat16``
    and ``.cast_float32``) at the same places, every slot, attribute and
    var dtype as the JAX package's."""
    want = _build_amp(jax_bert, jax_names, flash)[program].global_block()
    got = _build_amp(torch_bert, torch_names, flash)[program].global_block()
    assert [op.desc() for op in got.ops] == [op.desc() for op in want.ops]
    wv = [v.desc() for v in want.vars.values()]
    for v in wv:
        if v["dtype"] == "int32":
            v["dtype"] = "int64"
    assert [v.desc() for v in got.vars.values()] == wv
    if program == 0:
        types = [op.type for op in got.ops]
        assert types.count("cast") > 50
        sdpa = [op for op in got.ops if op.type == "scaled_dot_product_attention"]
        assert len(sdpa) == (2 if flash else 0)
        for op in sdpa:
            assert all(op.input(s)[0].endswith(".cast_bfloat16")
                       for s in ("Q", "K", "V"))
            assert not op.input("Bias")[0].endswith("bfloat16")


@pytest.fixture(scope="module")
def amp_runs():
    """The JAX AMP program and the port's from the JAX startup's state (the
    step counter past the warmup): 3 steps on one batch, every var the
    first step produces fetched, the loss after."""
    jmain, jstartup, _, jfetch = _build_amp(jax_bert, jax_names)
    tmain, tstartup, _, tfetch = _build_amp(torch_bert, torch_names)
    batch = jax_bert.synthetic_batch(np.random.RandomState(7), BATCH, SEQ,
                                     _amp_cfg(jax_bert, True), P)
    produced = sorted({n for op in tmain.global_block().ops
                       for n in op.output_names()} - set(batch))
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
    jscope.set(COUNTER, jnp.full([1], WARMED_UP, jnp.float32))
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None}
    with fluid.scope_guard(jscope), jax_kernels.scoped_mode("interpret"):
        jfirst = jexe.run(jmain, feed=batch, fetch_list=produced,
                          return_numpy=False)
        jloss = [float(np.asarray(jfirst[produced.index(jfetch[0].name)])[0])]
        for _ in range(2):
            jloss.append(float(jexe.run(jmain, feed=batch,
                                        fetch_list=[jfetch[0].name])[0][0]))
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    load_params(tscope, state)
    kernels.reset_launches()
    tfirst = texe.run(tmain, feed=batch, fetch_list=produced, scope=tscope,
                      return_numpy=False)
    tloss = [float(tfirst[produced.index(tfetch[0].name)][0])]
    for _ in range(2):
        tloss.append(float(texe.run(tmain, feed=batch, fetch_list=[tfetch[0]],
                                    scope=tscope)[0][0]))
    assert all(n == 0 for n in kernels.launches().values())
    return dict(produced=produced, jfirst=jfirst, tfirst=tfirst, jloss=jloss,
                tloss=tloss, tmain=tmain)


def test_amp_step_runtime_dtypes_match_jax(amp_runs):
    """Every var the AMP step produces has the JAX step's runtime dtype
    (int32 there is the port's int64: the JAX package runs 64-bit types
    off). Dropout sees float32 at every site: K8's masks need no 16-bit
    build."""
    from paddle_tpu_torch.core.dtypes import convert_dtype

    got = {n: convert_dtype(t.dtype)
           for n, t in zip(amp_runs["produced"], amp_runs["tfirst"])}
    want = {n: convert_dtype(str(a.dtype))
            for n, a in zip(amp_runs["produced"], amp_runs["jfirst"])}
    # the JAX package runs 64-bit types off: its int32 is the port's int32
    # or, for an index, int64
    assert set(got) == set(want)
    assert {n: g for n, g in got.items() if g != want[n]
            and not (want[n] == "int32" and g == "int64")} == {}
    assert sum(d == "bfloat16" for d in got.values()) > 100
    dropout = [op for op in amp_runs["tmain"].global_block().ops
               if op.type == "dropout"]
    assert len(dropout) == 5
    assert {got[op.input("X")[0]] for op in dropout} == {"float32"}
    assert {got[op.output("Mask")[0]] for op in dropout} == {"float32"}


def test_amp_dropout_masks_are_bit_equal_to_jax(amp_runs):
    produced = amp_runs["produced"]
    masks = [op.output("Mask")[0] for op in amp_runs["tmain"].global_block().ops
             if op.type == "dropout"]
    for name in masks:
        got = amp_runs["tfirst"][produced.index(name)].numpy()
        want = np.asarray(amp_runs["jfirst"][produced.index(name)])
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert 0.85 < got.mean() < 0.95


def test_amp_loss_stream_tracks_jax(amp_runs):
    got, want = amp_runs["tloss"], amp_runs["jloss"]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=AMP_LOSS_RTOL)
