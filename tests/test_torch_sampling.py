"""Committed-stream sampling in the PyTorch port against the JAX package,
on the CPU:

* ``core/prng.py`` gives ``jax.random``'s bytes: ``PRNGKey``,
  ``fold_in`` and ``bits`` (threefry2x32, partitionable) across seeds,
  steps and sizes;
* the port's ``gumbel_vector`` is bit-equal to the JAX package's, and
  ``sample_token`` picks the same token over a grid of temperature,
  top-k and top-p, greedy included;
* sampled decode (chunked prefill included), and sampled speculation
  with a draft that disagrees with the target, give the JAX engine's
  streams bit for bit under shuffled admission (vocab 64, hidden 16, 2
  layers, 4 slots, max_len 32, blocks of 4, a chunk budget of 5; the
  same weights through ``paddle_tpu_torch.convert``).
"""

import jax
import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu.serving.decode import GenerationEngine as JaxEngine
from paddle_tpu.serving.decode import build_decoder_model as jax_build
from paddle_tpu.serving.decode.generate import sampling as jax_sampling
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.serving.decode import GenerationEngine as TorchEngine
from paddle_tpu_torch.serving.decode import SamplingParams
from paddle_tpu_torch.serving.decode import build_decoder_model as torch_build
from paddle_tpu_torch.serving.decode.generate import sampling

GEOM = dict(vocab_size=64, hidden=16, num_layers=2, slots=4, max_len=32,
            block_size=4)
SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 40 + 3)


@pytest.mark.parametrize("size", [1, 5, 32000])
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_gives_the_bytes_of_jax_random(seed, size):
    key = jax.random.PRNGKey(seed)
    pkey = prng.prng_key(seed)
    np.testing.assert_array_equal(pkey, np.asarray(key))
    for step in (0, 1, 17, 2 ** 32 - 1):
        k = jax.random.fold_in(key, step)
        pk = prng.fold_in(pkey, step)
        np.testing.assert_array_equal(pk, np.asarray(k))
        want = np.asarray(jax.random.bits(k, (size,), "uint32"))
        got = prng.random_bits(pk, (size,))
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    # a shape of two dims counts its elements in row-major order
    np.testing.assert_array_equal(
        prng.random_bits(pkey, (3, size)),
        np.asarray(jax.random.bits(key, (3, size), "uint32")))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_vector_is_bit_equal_to_the_reference(seed):
    for step in (0, 3, 31):
        want = jax_sampling.gumbel_vector(seed, step, 64)
        got = sampling.gumbel_vector(seed, step, 64)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(got).all()


GRID = [dict(temperature=0.0),
        dict(temperature=1.0),
        dict(temperature=0.8, top_k=50, top_p=0.95),
        dict(temperature=0.5, top_k=5),
        dict(temperature=1.3, top_p=0.6),
        dict(temperature=2.0, top_k=1),
        dict(temperature=0.7, top_p=0.05)]


@pytest.mark.parametrize("params", GRID, ids=lambda p: ",".join(
    f"{k}={v}" for k, v in p.items()))
def test_sample_token_matches_the_reference(params):
    rng = np.random.RandomState(3)
    ours = SamplingParams(seed=11, **params)
    ref = jax_sampling.SamplingParams(seed=11, **params)
    picks = []
    for step in range(24):
        logits = (rng.randn(64) * 3).astype(np.float32)
        logits[[5, 9]] = logits.max() + 1.0     # a tie at the top
        np.testing.assert_array_equal(sampling.filtered_scores(logits, ours),
                                      jax_sampling.filtered_scores(logits, ref))
        got = sampling.sample_token(logits, ours, step)
        assert got == jax_sampling.sample_token(logits, ref, step)
        picks.append(got)
    if params["temperature"] == 0.0:
        assert picks == [5] * 24                # greedy: the first maximum
    elif params.get("top_k") != 1 and params.get("top_p", 1.0) > 0.5:
        assert len(set(picks)) > 1              # the noise moves the pick


@pytest.fixture(scope="module")
def served():
    """A JAX engine and a port engine (CPU) hosting the same target (with
    a chunk budget of 5 tokens, so longer prompts sample their first
    token from the last chunk) and the same 1-layer draft "d"."""
    draft = dict(GEOM, num_layers=1)
    jeng = JaxEngine(queue_depth=64, breaker_threshold=0)
    jt = jeng.register_model(jax_build(**GEOM, chunk_tokens=5, name="t"))
    jd = jeng.register_model(jax_build(**draft, name="d"))
    teng = TorchEngine(place=pt.CPUPlace(), queue_depth=64)
    tt = teng.register_model(torch_build(**GEOM, chunk_tokens=5, name="t"))
    td = teng.register_model(torch_build(**draft, name="d"))
    for j, t in ((jt, tt), (jd, td)):
        m = j.model
        arenas = {n for kv in m.state_names for n in kv}
        load_params(t.scope, {
            v.name: np.asarray(j._scope.find_var(v.name))
            for v in m.startup_program.global_block().vars.values()
            if v.persistable and v.name not in arenas})
    teng.start()
    jeng.start()
    yield jeng, jt, teng, tt
    teng.shutdown()
    jeng.shutdown()


def _traffic(seed, n=8):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 64, size=int(rng.randint(1, 12))).tolist()
               for _ in range(n)]
    max_news = [int(rng.randint(4, 14)) for _ in range(n)]
    params = [dict(temperature=float(rng.choice([0.6, 0.9, 1.2])),
                   top_k=int(rng.choice([0, 10, 40])),
                   top_p=float(rng.choice([0.8, 1.0])), seed=100 + i)
              for i in range(n)]
    return prompts, max_news, params, [int(i) for i in rng.permutation(n)]


@pytest.mark.parametrize("spec", [False, True], ids=["decode", "speculative"])
def test_sampled_streams_match_the_jax_engine(served, spec):
    jeng, jt, teng, tt = served
    prompts, max_news, params, order = _traffic(31 + spec)
    opts = dict(draft_model="d", spec_k=3) if spec else {}
    before = tt.stats()
    tr = {i: teng.submit(prompts[i], model="t", max_new_tokens=max_news[i],
                         sampling=SamplingParams(**params[i]), **opts)
          for i in order}
    jr = {i: jeng.submit(prompts[i], model="t", max_new_tokens=max_news[i],
                         sampling=dict(params[i]), **opts)
          for i in order}
    for i in order:
        got = [int(t) for t in tr[i].result(timeout=120)["tokens"]]
        jgot = [int(t) for t in jr[i].result(timeout=120)["tokens"]]
        own = tt.offline_decode(prompts[i], max_news[i], sampling=params[i])
        ref = jt.offline_decode(
            prompts[i], max_news[i],
            sampling=jax_sampling.SamplingParams(**params[i]))
        assert got == own == jgot == ref, (i, got, own, jgot, ref)
        greedy = tt.offline_decode(prompts[i], max_news[i])
        assert len(got) < 4 or got != greedy      # the stream is sampled
    st = tt.stats()
    assert st["sampled_tokens"] > before.get("sampled_tokens", 0)
    if not spec:
        assert st["chunk_runs"] > before["chunk_runs"]
    if spec:
        emitted = st["spec_emitted_tokens"] - before["spec_emitted_tokens"]
        assert emitted == sum(max_news)
        assert st["spec_accepted_tokens"] > before["spec_accepted_tokens"]
        assert st["spec_draft_kv_fallbacks"] == 0
