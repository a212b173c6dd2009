"""The Transformer's beam translator in the PyTorch port against the JAX
package's, on the CPU, from random-init tiny weights carried from the JAX
scope by name (``convert.transformer_params``):

* the port's decoder gives the JAX decoder's hypotheses exactly and its
  scores within rtol 1e-5, at beam 1 and 4;
* ties: ``stable_top_k`` orders equal values as ``lax.top_k`` does (the
  lower index first), and with an all-zero output embedding every
  candidate of every step ties, where the port's hypotheses are still
  the JAX decoder's;
* bucket padding in the port: the same tokens, the scores within rtol 1e-6
  (torch's CPU GEMMs sum the padded rows' products in another order;
  the JAX package's compiled decode is bit-equal);
* the cacheless forward (``decode_logits``) greedy-decodes the cached
  beam-1 decoder's tokens and rescores its hypotheses;
* ``tests/test_transformer.py``'s 32000-vocab shape check, the routing
  and batch-size errors, and the copy-task recipe's plumbing.
"""

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import transformer as jtfm
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import transformer_params
from paddle_tpu_torch.models import transformer as ttfm

CPU = pt.CPUPlace()
SRC = TGT = 12





from test_torch_beam import _assert_same_beams, _both, _port_cfg, _random_init


@pytest.fixture(scope="module")
def weights():
    """Random-init tiny weights: (cfg, jax params, port params)."""
    cfg = jtfm.TransformerConfig.tiny()
    return (cfg,) + _random_init(cfg)


@pytest.mark.parametrize("beam", [1, 4])
def test_random_init_weights_match_jax(weights, beam):
    cfg, jparams, tparams = weights
    src = np.random.RandomState(3).randint(3, cfg.vocab_size, (4, 10))
    jtoks, jscores, ttoks, tscores, stats = _both(
        cfg, jparams, tparams, src, beam, 12)
    _assert_same_beams(jtoks, jscores, ttoks, tscores)
    assert stats["steps"] == 12 and stats["syncs"] == 11


def test_stable_top_k_orders_ties_as_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, -2.0, 3.0, 1.0, 1.0, -1e9, -1e9],
                  [-1e9] * 5 + [0.0, -1e9, 0.0, -1e9]], np.float32)
    for k in (1, 3, 5, 8):
        jv, ji = jax.lax.top_k(x, k)
        tv, ti = ttfm.stable_top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("beam", [1, 4])
def test_all_candidates_tied_follow_the_jax_order(weights, beam):
    """A zero output embedding makes every logit 0: every candidate of a
    step ties with its beam's others, and finished beams' non-EOS
    candidates tie at score + NEG. The picks must be the JAX decoder's."""
    cfg, jparams, tparams = weights
    jparams = dict(jparams, word_emb=jparams["word_emb"] * 0)
    tparams = dict(tparams, word_emb=tparams["word_emb"] * 0)
    src = np.random.RandomState(5).randint(3, cfg.vocab_size, (3, 7))
    jtoks, jscores, ttoks, tscores, _ = _both(
        cfg, jparams, tparams, src, beam, 9)
    _assert_same_beams(jtoks, jscores, ttoks, tscores)


def test_bucket_padded_equals_exact_length(weights):
    cfg, _, tparams = weights
    pcfg = _port_cfg(cfg)
    body = np.random.RandomState(3).randint(3, cfg.vocab_size, (4, 10))
    tr = ttfm.BucketedBeamTranslator(pcfg, tparams, beam_size=2,
                                     src_buckets=(16, 32), place=CPU)
    toks_b, scores_b = tr.translate(body)
    toks_d, scores_d = ttfm.make_beam_decoder(pcfg, beam_size=2, place=CPU)(
        tparams, body)
    np.testing.assert_array_equal(toks_b, toks_d.numpy())
    np.testing.assert_allclose(scores_b, scores_d.numpy(), rtol=1e-6, atol=0)
    assert tr.stats["bucket_hits"][16] == 1


def test_translator_routing_and_errors(weights):
    cfg, _, tparams = weights
    rng = np.random.RandomState(4)
    tr = ttfm.BucketedBeamTranslator(_port_cfg(cfg), tparams, beam_size=2,
                                     src_buckets=(8, 16), batch_size=4,
                                     place=CPU)
    tr.warmup()
    tr.translate(rng.randint(3, cfg.vocab_size, (4, 5)).astype("int64"))
    tr.translate(rng.randint(3, cfg.vocab_size, (2, 12)).astype("int64"))
    assert tr.stats["bucket_hits"] == {8: 1, 16: 1}
    assert tr.stats["sentences"] == 6
    assert tr.stats["tokens"] > 0 and tr.tokens_per_sec() > 0
    assert tr.stats["syncs"] <= tr.stats["steps"]
    with pytest.raises(ValueError, match="bucket"):
        tr.translate(np.zeros((4, 20), "int64"))
    with pytest.raises(ValueError, match="batch"):
        tr.translate(np.zeros((5, 8), "int64"))


def test_translator_realistic_vocab():
    """``tests/test_transformer.py``'s shape check at a 32000 vocab."""
    cfg = ttfm.TransformerConfig(
        vocab_size=32000, d_model=64, n_heads=4, d_ffn=128,
        n_enc_layers=1, n_dec_layers=1, max_len=8,
    )
    _, startup, _, _ = ttfm.build_wmt_train(cfg, src_len=8, tgt_len=8)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(CPU).run(startup)
        params = ttfm.params_from_scope(cfg, scope)
    tr = ttfm.BucketedBeamTranslator(cfg, params, beam_size=4,
                                     src_buckets=(8,), place=CPU)
    src = np.random.RandomState(0).randint(3, cfg.vocab_size, (2, 6))
    toks, scores = tr.translate(src)
    assert toks.shape == (2, cfg.max_len)
    assert np.isfinite(scores).all()
    assert (toks < cfg.vocab_size).all() and (toks >= 0).all()


def test_decode_logits_is_the_cached_steps_reference(weights):
    """Greedy decoding by the cacheless forward picks the tokens of the
    cached beam-1 decoder (no length penalty), and rescoring its
    hypothesis (up to its EOS, else all ``L`` tokens) gives its score."""
    cfg, _, tparams = weights
    pcfg = _port_cfg(cfg)
    L = 10
    src = np.random.RandomState(9).randint(3, cfg.vocab_size, (4, 8))
    toks, scores = ttfm.make_beam_decoder(pcfg, beam_size=1, max_len=L,
                                          length_penalty=0.0, place=CPU)(
        tparams, src)
    tgt = np.full((4, L + 1), cfg.bos_id, np.int64)
    for t in range(L):
        logits = ttfm.decode_logits(tparams, pcfg, src, tgt[:, :t + 1],
                                    place=CPU)
        tgt[:, t + 1] = logits[:, t].argmax(-1).numpy()
    logp = torch.log_softmax(ttfm.decode_logits(tparams, pcfg, src,
                                                tgt[:, :L], place=CPU),
                             -1).numpy()
    toks = toks.numpy()
    for b in range(4):
        eos = np.nonzero(toks[b] == cfg.eos_id)[0]
        n = eos[0] + 1 if len(eos) else L
        np.testing.assert_array_equal(toks[b, :n], tgt[b, 1:n + 1])
        rescored = sum(logp[b, t, toks[b, t]] for t in range(n))
        np.testing.assert_allclose(rescored, scores[b].item(), rtol=1e-5)


def test_copy_task_recipe_plumbing():
    """``examples/machine_translation.py``'s recipe (a few steps here;
    phase 14b of ``chip_smoke.py`` runs the 300 on the card)."""
    cfg, losses, tr, body, toks, scores, copied = ttfm.copy_task_recipe(
        steps=3, place=CPU)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert tr.buckets == (12, 16) and tr.batch_size == 8
    assert toks.shape == (8, cfg.max_len) and body.shape == (8, 11)
    assert 0 <= copied <= 8 and np.isfinite(scores).all()

