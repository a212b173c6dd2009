"""The Transformer's beam translator in the PyTorch port against the JAX
package's, on the CPU (``models/transformer.py``: ``params_from_scope``,
``make_beam_decoder``), on a trained model.

The tiny copy model is trained by the JAX package as
``tests/test_transformer.py``'s fixture trains it, in 200 steps at lr
4e-3 where that fixture takes 400 at 2e-3 (the same copy accuracy,
half the time), and its weights cross from the JAX scope by name
(``convert.transformer_params``). From the same weights and sources the
port's decoder gives the JAX decoder's hypotheses exactly and its
length-penalised scores within rtol 1e-5, at beam 1 and 4; the model
copies.
The EOS stop: after a row's first EOS only EOS or pad follows, and the
loop stops at the first step where every beam has finished, after one
host sync a step. ``tests/test_torch_beam_translator.py`` holds the
random-init weights, the ties and the translator.
"""

import numpy as np
import pytest

import jax

import paddle_tpu as fluid
from paddle_tpu.models import transformer as jtfm
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import transformer_params
from paddle_tpu_torch.models import transformer as ttfm

CPU = pt.CPUPlace()
SRC = TGT = 12


@pytest.fixture(scope="module")
def trained():
    """The tiny copy model: (cfg, jax params, port params)."""
    cfg = jtfm.TransformerConfig.tiny()
    main, startup, _, fetches = jtfm.build_wmt_train(
        cfg, src_len=SRC, tgt_len=TGT, optimizer=fluid.optimizer.Adam(4e-3))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    rng = np.random.RandomState(0)
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(200):
            exe.run(main, feed=jtfm.synthetic_batch(rng, 32, SRC, TGT, cfg),
                    fetch_list=[fetches[0]])
        jparams = jtfm.params_from_scope(cfg, scope)
    return cfg, jparams, transformer_params(scope, _port_cfg(cfg))


def _port_cfg(cfg):
    return ttfm.TransformerConfig(**vars(cfg))


def _random_init(cfg):
    _, startup, _, _ = jtfm.build_wmt_train(cfg, src_len=8, tgt_len=8)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        jparams = jtfm.params_from_scope(cfg, scope)
    return jparams, transformer_params(scope, _port_cfg(cfg))


def _both(cfg, jparams, tparams, src, beam, max_len):
    jdec = jtfm.make_beam_decoder(cfg, beam_size=beam, max_len=max_len)
    jtoks, jscores = jdec(jparams, np.asarray(src, np.int32))
    tdec = ttfm.make_beam_decoder(_port_cfg(cfg), beam_size=beam,
                                  max_len=max_len, place=CPU)
    ttoks, tscores = tdec(tparams, src)
    return (np.asarray(jtoks), np.asarray(jscores), ttoks.numpy(),
            tscores.numpy(), tdec.stats)


def _assert_same_beams(jtoks, jscores, ttoks, tscores):
    np.testing.assert_array_equal(ttoks, jtoks)
    np.testing.assert_allclose(tscores, jscores, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("beam", [1, 4])
def test_trained_copy_model_matches_jax(trained, beam):
    cfg, jparams, tparams = trained
    feed = jtfm.synthetic_batch(np.random.RandomState(7), 8, SRC, TGT, cfg)
    jtoks, jscores, ttoks, tscores, _ = _both(
        cfg, jparams, tparams, feed["src_ids"], beam, TGT)
    _assert_same_beams(jtoks, jscores, ttoks, tscores)
    # the trained model copies (tests/test_transformer.py's greedy gate)
    assert (ttoks[:, :TGT] == feed["labels"]).mean() > 0.8


def test_decode_stops_on_eos(trained):
    cfg, jparams, tparams = trained
    feed = jtfm.synthetic_batch(np.random.RandomState(3), 4, SRC, TGT, cfg)
    jtoks, jscores, ttoks, tscores, stats = _both(
        cfg, jparams, tparams, feed["src_ids"], 2, 2 * TGT)
    _assert_same_beams(jtoks, jscores, ttoks, tscores)
    first = []
    for row in ttoks:
        eos = np.nonzero(row == cfg.eos_id)[0]
        assert len(eos), row
        assert np.isin(row[eos[0]:], [cfg.eos_id, cfg.pad_id]).all()
        first.append(eos[0])
    # every beam finished before max_len: the loop stopped there, one
    # host sync after each step but the last
    assert max(first) < stats["steps"] < 2 * TGT
    assert stats["syncs"] == stats["steps"]
