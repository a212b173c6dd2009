"""The port's random-key stream against the JAX package's, on the CPU:

* ``core/prng.py``'s host keys are ``jax.random``'s: ``PRNGKey``,
  ``fold_in`` and the partitionable ``split``;
* each random op (``gaussian_random``, ``uniform_random`` with and without
  ``ShapeTensor``, ``truncated_gaussian_random``, ``randint``, ``randperm``,
  ``bernoulli``), each ``*_batch_size_like`` op and ``dropout`` (``CASES``,
  which ``tests/test_torch_ops.py`` counts toward its coverage of every
  ported op type) run under the same ``__rng_key__`` as the JAX op's
  lowering, for three keys, with and without a ``seed`` attribute, at odd
  shapes. Every one is held equal bit for bit, the normals too: the port
  computes XLA's CPU ``ErfInv`` and ``log1p`` with XLA's fused
  multiply-adds (``core/prng.py``), so the share of draws that differ is
  0 and the bar "within 2 float32 ULP" is not needed;
* the executor's key stream equals the JAX executor's across a startup
  run, a training run, an eval run of ``clone(for_test=True)`` and another
  training run (each run advances the counter), for ``random_seed`` 0 and
  1234: the fetched draws of a ``uniform_random`` op and a dropout mask in
  the main program are equal, run by run, and the startup's normal draws;
* the startup programs of tiny BERT (truncated normal) and tiny
  Transformer (Xavier uniform) give the JAX startup's parameters bit for
  bit;
* ``FLAGS_rng_impl`` takes only ``"threefry"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import OpRegistry as JaxOps
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.models import transformer as jax_tfm
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.registry import OpRegistry as TorchOps
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.models import transformer as torch_tfm
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.flags import flags

R = np.random.RandomState(17)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


# op type -> (inputs {slot: [np arrays]}, attrs): odd shapes throughout
CASES = {
    "gaussian_random": ({}, {"shape": [37, 11], "dtype": "float32",
                             "mean": 0.5, "std": 2.0}),
    "uniform_random": ({}, {"shape": [3, 1001], "dtype": "float32",
                            "min": -0.0731, "max": 0.0731}),
    "truncated_gaussian_random": ({}, {"shape": [129, 7], "dtype": "float32",
                                       "mean": 0.0, "std": 0.02}),
    "randint": ({}, {"shape": [5, 7], "low": -3, "high": 1000,
                     "dtype": "int64"}),
    "randperm": ({}, {"n": 1001}),
    "bernoulli": ({"X": [R.rand(13, 9).astype(np.float32)]}, {}),
    "dropout": ({"X": [f32(3, 5, 7)]},
                {"dropout_prob": 0.1,
                 "dropout_implementation": "upscale_in_train"}),
    "uniform_random_batch_size_like": (
        {"Input": [f32(6, 4)]}, {"shape": [-1, 9], "min": -0.5, "max": 0.25}),
    "gaussian_random_batch_size_like": (
        {"Input": [f32(5, 3)]}, {"shape": [7, -1], "input_dim_idx": 1,
                                 "output_dim_idx": 1, "mean": 1.0,
                                 "std": 0.5}),
}

# (seed, fold) pairs: the key fold_in(PRNGKey(seed), fold)
KEYS = [(0, None), (7, 3), (2 ** 31 + 5, 11)]


def _keys(seed, fold):
    jkey = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    if fold is not None:
        jkey, tkey = jax.random.fold_in(jkey, fold), prng.fold_in(tkey, fold)
    return jkey, tkey


def _run_jax(op_type, ins, attrs, key):
    jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    jins["__rng_key__"] = [key]
    out = JaxOps.get(op_type).lower(jins, dict(attrs))
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


def _run_torch(op_type, ins, attrs, key):
    op_def = TorchOps.get(op_type)
    tins = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in ins.items()}
    tins["__rng_key__"] = [key]
    if op_def.creates:
        tins["__device__"] = [torch.device("cpu")]
    out = op_def.lowering()(tins, dict(attrs))
    return {k: [t.numpy() for t in v] for k, v in out.items()}


@pytest.mark.parametrize("seed_attr", [0, 42], ids=["key", "seed_attr"])
@pytest.mark.parametrize("key", KEYS, ids=["k0", "k7", "kbig"])
@pytest.mark.parametrize("op_type", sorted(CASES))
def test_random_op_is_bit_equal_to_jax(op_type, key, seed_attr):
    ins, attrs = CASES[op_type]
    attrs = dict(attrs, seed=seed_attr)
    jkey, tkey = _keys(*key)
    want = _run_jax(op_type, ins, attrs, jkey)
    got = _run_torch(op_type, ins, attrs, tkey)
    assert sorted(got) == sorted(want)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            # the JAX package runs int64 as int32: compare values
            if np.issubdtype(w.dtype, np.floating):
                assert g.dtype == w.dtype, slot
            np.testing.assert_array_equal(g, w, err_msg=slot)


def test_uniform_random_takes_its_shape_from_shape_tensor():
    ins = {"ShapeTensor": [np.array([3, 5], np.int64)]}
    attrs = {"shape": [1, 1], "min": -1.0, "max": 1.0}
    jkey, tkey = _keys(7, 3)
    want = _run_jax("uniform_random", ins, attrs, jkey)["Out"][0]
    got = _run_torch("uniform_random", ins, attrs, tkey)["Out"][0]
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_host_keys_are_jax_random_keys(seed):
    jkey, tkey = _keys(seed, None)
    np.testing.assert_array_equal(tkey, np.asarray(jkey))
    for data in (0, 1, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tkey, data),
                                      np.asarray(jax.random.fold_in(jkey, data)))
    for num in (2, 3):
        np.testing.assert_array_equal(np.asarray(prng.split(tkey, num)),
                                      np.asarray(jax.random.split(jkey, num)))


def test_torch_bits_are_the_host_bits():
    key = prng.fold_in(prng.prng_key(3), 9)
    got = prng.random_bits_torch(key, 4099).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, prng.random_bits(key, (4099,)))


def _stream_program(pkg, names, seed):
    """A startup with a normal-initialised weight; a main program with a
    ``uniform_random`` draw, a dropout over the fc output and SGD, so the
    dropout grad runs too."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with names.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [4, 6])
        h = pkg.layers.fc(x, size=5, param_attr=pkg.ParamAttr(
            name="w", initializer=pkg.initializer.Normal(0.0, 1.0)))
        h = pkg.layers.dropout(h, 0.5,
                               dropout_implementation="upscale_in_train")
        r = pkg.layers.uniform_random([3, 7], min=0.0, max=1.0)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(h, h))
        test = main.clone(for_test=True)
        pkg.optimizer.SGD(0.1).minimize(loss)
    mask = [op.output("Mask")[0] for op in main.global_block().ops
            if op.type == "dropout"][0]
    return main, startup, test, [r.name, mask, loss.name]


@pytest.mark.parametrize("seed", [0, 1234])
def test_key_stream_matches_the_jax_executor(seed):
    """startup, train, eval (``clone(for_test=True)``), train: every run
    advances the counter in both executors, so each run draws the same
    values; the eval run's dropout passes its input through."""
    jmain, jstartup, jtest, fetch = _stream_program(fluid, jax_names, seed)
    tmain, tstartup, ttest, tfetch = _stream_program(pt, torch_names, seed)
    assert fetch == tfetch
    feed = {"x": np.random.RandomState(1).randn(4, 6).astype(np.float32)}
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
    texe.run(tstartup, scope=tscope)
    np.testing.assert_array_equal(tscope.find_var("w").numpy(),
                                  np.asarray(jscope.find_var("w")))
    draws = []
    for program in ("main", "test", "main"):
        jprog, tprog = ((jmain, tmain) if program == "main"
                        else (jtest, ttest))
        with fluid.scope_guard(jscope):
            want = jexe.run(jprog, feed=feed, fetch_list=fetch)
        got = texe.run(tprog, feed=feed, fetch_list=fetch, scope=tscope)
        for g, w, name in zip(got[:2], want, fetch):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        # the loss sums float32 in another order (and the jitted JAX step
        # multiplies by the reciprocal of 1 - p where the op divides)
        np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-6)
        draws.append(got[0])
    assert jexe._rng_counter == texe._rng_counter == 4
    # each run draws anew
    assert not np.array_equal(draws[0], draws[2])


def _jax_startup(main_startup):
    main, startup = main_startup
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    return {p.name: np.asarray(scope.find_var(p.name))
            for p in main.all_parameters()}


def _torch_startup(main_startup):
    main, startup = main_startup
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    return {p.name: scope.find_var(p.name).numpy()
            for p in main.all_parameters()}


def _bert(mod, names):
    cfg = mod.BertConfig.tiny()
    cfg.use_flash_attention = True
    cfg.attention_probs_dropout_prob = 0.0
    with names.guard():
        return mod.build_bert_pretrain(cfg, seq_len=16,
                                       max_predictions_per_seq=3)[:2]


def _transformer(mod, names):
    cfg = mod.TransformerConfig(vocab_size=512, d_model=32, n_heads=4,
                                d_ffn=64, n_enc_layers=1, n_dec_layers=1,
                                max_len=16, dropout=0.1)
    with names.guard():
        return mod.build_wmt_train(cfg, src_len=8, tgt_len=8)[:2]


@pytest.mark.parametrize("model", ["bert", "transformer"])
def test_startup_gives_the_jax_startup_parameters(model):
    build = {"bert": _bert, "transformer": _transformer}[model]
    want = _jax_startup(build({"bert": jax_bert,
                               "transformer": jax_tfm}[model], jax_names))
    got = _torch_startup(build({"bert": torch_bert,
                                "transformer": torch_tfm}[model],
                               torch_names))
    assert sorted(got) == sorted(want)
    drawn = 0
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
        drawn += int(np.abs(w).max() > 0 and len(np.unique(w)) > 2)
    assert drawn >= 10


def test_rng_impl_takes_only_threefry():
    assert flags.rng_impl == "threefry"
    for impl in ("rbg", "unsafe_rbg"):
        with pytest.raises(NotImplementedError, match="threefry"):
            flags.rng_impl = impl
    assert flags.rng_impl == "threefry"
