"""Dropout in the PyTorch port against the JAX package, on the CPU:

* the ``dropout`` op and its registered grad against the JAX lowerings,
  both ``dropout_implementation``s, training and ``is_test``, three
  probabilities, odd shapes: ``Out``, ``Mask`` and ``X@GRAD`` bit for bit
  (the grad is ``dOut * Mask``, divided by ``1 - p`` when upscaling; it
  never draws again);
* tiny BERT (``BertConfig.tiny()``, seq 32, batch 4, P 5) with
  ``hidden_dropout_prob=0.1`` on the flash path (the JAX package's flash
  kernels in interpret mode, the port's through their plain versions),
  tiny unfused BERT with both dropouts at 0.1, and the tiny Transformer of
  ``tests/test_torch_transformer.py`` with ``dropout=0.1``: each package
  runs its OWN startup program (the random ops give the same weights),
  then 3 steps at the full learning rate. Every mask the port draws in the
  first step equals ``jax.random.bernoulli`` under the JAX executor's key
  for that op (``fold_in(fold_in(PRNGKey(0), run), __rng_id__)``); the
  loss stream and the first step's grads agree within the bars of
  ``tests/test_torch_bert.py`` (loss rtol 1e-4, atol 1e-5; grads rtol
  1e-4, atol 1e-6) and ``tests/test_torch_transformer.py`` (loss rtol
  1e-5, atol 1e-6). The JAX step is one jitted program, in which XLA
  multiplies by the float32 reciprocal of ``1 - p`` where the op divides
  (a last-bit difference on about a quarter of the kept elements), far
  inside those bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import kernels as jax_kernels
from paddle_tpu.core.backward import resolve_op_def as jax_resolve
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.models import transformer as jax_tfm
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.backward import resolve_op_def as torch_resolve
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.models import transformer as torch_tfm
from paddle_tpu_torch.utils import unique_name as torch_names

R = np.random.RandomState(23)
COUNTER = "@LR_DECAY_COUNTER@"


@pytest.mark.parametrize("shape", [(3, 5, 7), (1001,)], ids=["3d", "odd"])
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_and_grad_match_jax(impl, is_test, p, shape):
    x = R.randn(*shape).astype(np.float32)
    dout = R.randn(*shape).astype(np.float32)
    attrs = {"dropout_prob": p, "is_test": is_test, "seed": 0,
             "dropout_implementation": impl}
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    tkey = prng.fold_in(prng.prng_key(5), 2)
    want = jax_resolve("dropout").lower(
        {"X": [jnp.asarray(x)], "__rng_key__": [jkey]}, dict(attrs))
    got = get_op_def("dropout").lowering()(
        {"X": [torch.from_numpy(x)], "__rng_key__": [tkey]}, dict(attrs))
    for slot in ("Out", "Mask"):
        np.testing.assert_array_equal(got[slot][0].numpy(),
                                      np.asarray(want[slot][0]), slot)
    mask = np.asarray(want["Mask"][0])
    if not is_test:
        assert 0 < mask.mean() < 1 or shape == (3, 5, 7) and p == 0.9
    gins = {"X": [x], "Out": [np.asarray(want["Out"][0])], "Mask": [mask],
            "Out@GRAD": [dout]}
    gattrs = dict(attrs, __fwd_inputs__=["X"], __fwd_outputs__=["Out", "Mask"])
    jgrad = jax_resolve("dropout_grad").lower(
        {k: [jnp.asarray(a) for a in v] for k, v in gins.items()}, gattrs)
    tgrad = torch_resolve("dropout_grad").lowering()(
        {k: [torch.from_numpy(a.copy()) for a in v] for k, v in gins.items()},
        gattrs)
    np.testing.assert_array_equal(tgrad["X@GRAD"][0].numpy(),
                                  np.asarray(jgrad["X@GRAD"][0]))


class _MaskTap:
    """Records every ``Mask`` the port's dropout lowering returns, with the
    op's key and ``__rng_id__`` (patched onto the op def the executor's
    plan calls)."""

    def __init__(self, monkeypatch):
        self.masks = []
        op_def = get_op_def("dropout")
        inner = op_def.lowering()

        def tapped(ins, attrs):
            outs = inner(ins, attrs)
            self.masks.append((attrs["__rng_id__"],
                               outs["Mask"][0].detach().numpy().copy()))
            return outs

        monkeypatch.setattr(op_def, "kernel", tapped)


def _jax_masks(taps, run, p, seed=0):
    """The masks the JAX executor's run ``run`` draws at the tapped ops."""
    run_key = jax.random.fold_in(jax.random.PRNGKey(seed), run)
    return [np.asarray(jax.random.bernoulli(
        jax.random.fold_in(run_key, rng_id), 1.0 - p, m.shape)).astype(
            np.float32) for rng_id, m in taps]


def _bert_cfg(mod, flash):
    cfg = mod.BertConfig.tiny()
    cfg.use_flash_attention = flash
    cfg.hidden_dropout_prob = 0.1
    cfg.attention_probs_dropout_prob = 0.0 if flash else 0.1
    return cfg


def _train_both(jbuilt, tbuilt, batch, steps, monkeypatch, grads=(),
                counter=None, jax_mode="interpret"):
    """Each package's own startup, then ``steps`` steps on ``batch``:
    (jax runs, port runs, tapped masks of the port's first step)."""
    jmain, jstartup, _, jf = jbuilt
    tmain, tstartup, _, tf = tbuilt
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    if counter is not None:
        jscope.set(COUNTER, jnp.full([1], counter, jnp.float32))
        load_params(tscope, {COUNTER: np.full([1], counter, np.float32)})
    jrun = []
    with fluid.scope_guard(jscope), jax_kernels.scoped_mode(jax_mode):
        for step in range(steps):
            jrun.append(jexe.run(jmain, feed=batch, fetch_list=[jf[0].name]
                                 + (list(grads) if step == 0 else [])))
    tap = _MaskTap(monkeypatch)
    trun = []
    for step in range(steps):
        trun.append(texe.run(tmain, feed=batch, fetch_list=[tf[0].name]
                             + (list(grads) if step == 0 else []),
                             scope=tscope))
        if step == 0:
            first = list(tap.masks)
    return jrun, trun, first


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "unfused"])
def test_tiny_bert_with_dropout_trains_as_jax(flash, monkeypatch):
    seq, batch_size, P = 32, 4, 5
    with jax_names.guard():
        jbuilt = jax_bert.build_bert_pretrain(
            _bert_cfg(jax_bert, flash), seq_len=seq, lr=1e-3,
            max_predictions_per_seq=P)
    with torch_names.guard():
        tbuilt = torch_bert.build_bert_pretrain(
            _bert_cfg(torch_bert, flash), seq_len=seq, lr=1e-3,
            max_predictions_per_seq=P)
    grads = [p.name + "@GRAD" for p in tbuilt[0].all_parameters()]
    batch = jax_bert.synthetic_batch(np.random.RandomState(5), batch_size,
                                     seq, _bert_cfg(jax_bert, flash), P)
    jrun, trun, masks = _train_both(jbuilt, tbuilt, batch, 3, monkeypatch,
                                    grads=grads, counter=10000.0)
    # 1 + 2 per layer hidden sites; unfused adds one attention-prob site
    # a layer
    assert len(masks) == (5 if flash else 7)
    for (rng_id, got), want in zip(masks, _jax_masks(masks, 2, 0.1)):
        np.testing.assert_array_equal(got, want, err_msg=str(rng_id))
    assert all(0.85 < m.mean() < 0.95 for _, m in masks)
    np.testing.assert_allclose([float(r[0][0]) for r in trun],
                               [float(r[0][0]) for r in jrun],
                               rtol=1e-4, atol=1e-5)
    for name, g, w in zip(grads, trun[0][1:], jrun[0][1:]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_tiny_transformer_with_dropout_trains_as_jax(monkeypatch):
    cfg = dict(vocab_size=512, d_model=32, n_heads=4, d_ffn=64,
               n_enc_layers=1, n_dec_layers=1, max_len=16, dropout=0.1)
    seq = 8
    with jax_names.guard():
        jbuilt = jax_tfm.build_wmt_train(
            jax_tfm.TransformerConfig(**cfg), src_len=seq, tgt_len=seq,
            optimizer=fluid.optimizer.Adam(2e-3))
    with torch_names.guard():
        tbuilt = torch_tfm.build_wmt_train(
            torch_tfm.TransformerConfig(**cfg), src_len=seq, tgt_len=seq,
            optimizer=pt.optimizer.Adam(2e-3))
    batch = jax_tfm.synthetic_batch(np.random.RandomState(3), 4, seq, seq,
                                    jax_tfm.TransformerConfig(**cfg))
    jrun, trun, masks = _train_both(jbuilt, tbuilt, batch, 3, monkeypatch)
    # 2 embeddings; encoder: attention probs + 2 sublayers; decoder:
    # 2 attentions' probs + 3 sublayers
    assert len(masks) == 10
    for (rng_id, got), want in zip(masks, _jax_masks(masks, 2, 0.1)):
        np.testing.assert_array_equal(got, want, err_msg=str(rng_id))
    tl = [float(r[0].reshape(-1)[0]) for r in trun]
    np.testing.assert_allclose(tl, [float(np.asarray(r[0]).reshape(-1)[0])
                                    for r in jrun], rtol=1e-5, atol=1e-6)
    assert tl[-1] < tl[0]
