"""The inference predictor in the PyTorch port against the JAX package's,
on the CPU.

* The default pipeline on tiny BERT, the ``serve_transformer`` encoder, a
  conv+bn+fc net and ``recognize_digits``: a model exported by either
  package, loaded by the port's predictor, gives the JAX predictor's
  ``analysis_stats``, analyzed op types and outputs within ``TOL``; in
  bf16 within ``BF16_TOL`` of the JAX bf16 predictor, with the same
  folded weights (a tied table kept in float32 for its lookup).
* The predictor's surface: handles, clones, buckets and their counters,
  ``save_optim_model``, a run that writes nothing to the shared scope,
  the config's passes and precisions, and no CPU fallback without a card.

The builders here (shared with ``test_torch_passes.py``) build the same
program in either package under each package's ``unique_name.guard()``;
the JAX startup's weights carry into the port by name.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import inference as jax_inference
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch import inference
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.enforce import EnforceError
from test_torch_io import recognize_digits

#: float32: the same ops in another package sum in another order
TOL = 1e-5
#: bf16: both packages round the same products' operands to bf16; the
#: products sum in float32 in another order, so outputs part by a few
#: bf16 ulps of the largest output
BF16_TOL = 2e-2

SEQ = 16


def _types(program):
    return [op.type for op in program.global_block().ops]


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy() \
            if v.dtype == torch.bfloat16 else v.detach().cpu().numpy()
    return np.asarray(v)


# ---------------------------------------------------------------------------
# builders: fn(mod) -> (main, startup, feed names, fetch vars)
# ---------------------------------------------------------------------------


def fc_net(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod.data("x", shape=[-1, 8], dtype="float32")
        h = mod.layers.fc(x, size=16, act="relu")
        drop = mod.layers.dropout(h, 0.3)
        y = mod.layers.fc(drop, size=4)
    return main, startup, ["x"], [y]


def shared_fc(mod):
    """The fc's add output is fetched too: fc still fuses, and writes it."""
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod.data("x", shape=[-1, 8], dtype="float32")
        h = mod.layers.fc(x, size=4)
        y = mod.layers.reduce_sum(h)
    return main, startup, ["x"], [y, h]


def dce_net(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod.data("x", shape=[4, 4], dtype="float32")
        live = mod.layers.scale(x, scale=2.0)
        mod.layers.scale(x, scale=3.0)  # unfetched
    return main, startup, ["x"], [live]


def const_net(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod.data("x", shape=[4, 2], dtype="float32")
        c = mod.layers.fill_constant([2, 2], "float32", 3.0)
        c2 = mod.layers.scale(c, scale=2.0)  # constant chain: 6.0
        out = mod.layers.matmul(x, c2)
    return main, startup, ["x"], [out]


def conv_bn(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        img = mod.data("img", shape=[-1, 3, 8, 8], dtype="float32")
        c = mod.layers.conv2d(img, num_filters=6, filter_size=3, padding=1)
        b = mod.layers.batch_norm(c)
        y = mod.layers.reduce_sum(b)
    return main, startup, ["img"], [y, b]


def conv_bn_fc(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        img = mod.data("img", shape=[-1, 3, 8, 8], dtype="float32")
        c = mod.layers.conv2d(img, num_filters=4, filter_size=3)
        bn = mod.layers.batch_norm(c, act="relu")
        flat = mod.layers.reshape(bn, [0, 4 * 6 * 6])
        logits = mod.layers.fc(flat, size=3)
    return main, startup, ["img"], [logits]


def tiny_bert(mod):
    bert = jax_bert if mod is fluid else torch_bert
    cfg = bert.BertConfig.tiny()  # unfused attention, dropouts 0.1
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        ids = mod.data("input_ids", shape=[-1, SEQ], dtype="int64")
        tt = mod.data("tt", shape=[-1, SEQ], dtype="int64")
        mask = mod.data("mask", shape=[-1, SEQ], dtype="int64")
        seq_out, pooled = bert.bert_encoder(ids, tt, mask, cfg, SEQ)
    return main, startup, ["input_ids", "tt", "mask"], [seq_out, pooled]


VOCAB, D_MODEL, N_CLASSES = 100, 16, 5


def serve_transformer(mod):
    """``examples/serve_transformer.py``'s ``build_programs``: one masked
    self-attention block with a per-token classifier head."""
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        ids = mod.data("ids", shape=[-1, -1], dtype="int64")
        mask = mod.data("mask", shape=[-1, -1], dtype="float32")
        emb = mod.layers.embedding(ids, size=(VOCAB, D_MODEL))
        q = mod.layers.fc(emb, D_MODEL, num_flatten_dims=2)
        k = mod.layers.fc(emb, D_MODEL, num_flatten_dims=2)
        v = mod.layers.fc(emb, D_MODEL, num_flatten_dims=2)
        scores = mod.layers.matmul(
            q, k, transpose_y=True, alpha=1.0 / float(np.sqrt(D_MODEL)))
        bias = mod.layers.unsqueeze(
            mod.layers.scale(mask, scale=1e9, bias=-1e9), [1])
        att = mod.layers.softmax(
            mod.layers.elementwise_add(scores, bias), axis=-1)
        ctx = mod.layers.matmul(att, v)
        h = mod.layers.elementwise_add(ctx, emb)
        ffn = mod.layers.fc(h, 4 * D_MODEL, act="relu", num_flatten_dims=2)
        logits = mod.layers.fc(ffn, N_CLASSES, num_flatten_dims=2)
    return main, startup, ["ids", "mask"], [logits]


def tied_embedding(mod):
    """An embedding table read by its lookup and, tied, by the output
    product: bf16 folding must keep the float32 table for the lookup."""
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        ids = mod.data("ids", shape=[-1, 6], dtype="int64")
        emb = mod.layers.embedding(
            ids, size=(32, 8), param_attr=mod.ParamAttr(name="tied_emb"))
        table = main.global_block().var("tied_emb")
        logits = mod.layers.matmul(emb, table, transpose_y=True)
    return main, startup, ["ids"], [logits]


def digits(mod):
    main, startup, feeds, target = recognize_digits(mod)
    return main, startup, feeds, [target]


FEEDS = {
    "fc_net": lambda r: {"x": r.randn(5, 8).astype("float32")},
    "shared_fc": lambda r: {"x": r.randn(5, 8).astype("float32")},
    "dce_net": lambda r: {"x": r.randn(4, 4).astype("float32")},
    "const_net": lambda r: {"x": r.randn(4, 2).astype("float32")},
    "conv_bn": lambda r: {"img": r.randn(4, 3, 8, 8).astype("float32")},
    "conv_bn_fc": lambda r: {"img": r.randn(2, 3, 8, 8).astype("float32")},
    "tiny_bert": lambda r: {
        "input_ids": r.randint(0, 1024, (3, SEQ)).astype("int64"),
        "tt": r.randint(0, 2, (3, SEQ)).astype("int64"),
        # row 2 is a padded row: every key masked
        "mask": np.stack([np.ones(SEQ), np.r_[np.ones(9), np.zeros(SEQ - 9)],
                          np.zeros(SEQ)]).astype("int64")},
    "serve_transformer": lambda r: {
        "ids": r.randint(1, VOCAB, (2, 7)).astype("int64"),
        "mask": np.r_[np.ones((1, 7)), [[1, 1, 1, 1, 0, 0, 0]]].astype(
            "float32")},
    "tied_embedding": lambda r: {
        "ids": r.randint(0, 32, (3, 6)).astype("int64")},
    "digits": lambda r: {"img": r.randn(4, 1, 28, 28).astype("float32")},
}
BUILDERS = {f.__name__: f for f in (
    fc_net, shared_fc, dce_net, const_net, conv_bn, conv_bn_fc, tiny_bert,
    serve_transformer, tied_embedding, digits)}


class Pair:
    """The same builder in both packages, the port's scope holding the
    JAX startup's weights (and, with ``train_steps``, the JAX scope after
    that many runs of the main program: batch_norm's moving statistics
    move off their initial values)."""

    def __init__(self, name, train_steps=0):
        self.name = name
        builder = BUILDERS[name]
        with jax_names.guard():
            self.jmain, jstartup, self.feeds, jfetch = builder(fluid)
        with torch_names.guard():
            self.tmain, tstartup, _, tfetch = builder(pt)
        self.fetch = [v.name for v in jfetch]
        assert [v.name for v in tfetch] == self.fetch
        assert _types(self.tmain) == _types(self.jmain)
        self.feed = FEEDS[name](np.random.RandomState(7))
        self.jexe = fluid.Executor(fluid.CPUPlace())
        self.texe = pt.Executor(place=pt.CPUPlace())
        self.jscope, self.tscope = fluid.Scope(), pt.Scope()
        with fluid.scope_guard(self.jscope):
            self.jexe.run(jstartup)
            for _ in range(train_steps):
                self.jexe.run(self.jmain, feed=self.feed,
                              fetch_list=self.fetch[:1])
        with pt.scope_guard(self.tscope):
            self.texe.run(tstartup)
        names = [v.name for v in self.tmain.global_block().vars.values()
                 if v.persistable and not v.is_data]
        load_params(self.tscope, {n: np.asarray(self.jscope.find_var(n))
                                  for n in names})

    def run_jax(self, program):
        with fluid.scope_guard(self.jscope):
            return [np.asarray(o) for o in self.jexe.run(
                program, feed=self.feed, fetch_list=self.fetch)]

    def run_port(self, program):
        with pt.scope_guard(self.tscope):
            return self.texe.run(program, feed=self.feed,
                                 fetch_list=self.fetch)

    def export(self, root):
        """Save the inference model from each package; returns the dirs."""
        dirs = {"jax": os.path.join(root, "jax"),
                "port": os.path.join(root, "port")}
        with fluid.scope_guard(self.jscope):
            fluid.io.save_inference_model(
                dirs["jax"], self.feeds, self.fetch, self.jexe,
                main_program=self.jmain)
        with pt.scope_guard(self.tscope):
            pt.io.save_inference_model(
                dirs["port"], self.feeds, self.fetch, self.texe,
                main_program=self.tmain)
        return dirs


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the default pipeline through the predictors
# ---------------------------------------------------------------------------


def _jax_predictor(model_dir, bf16=False):
    cfg = jax_inference.Config(model_dir)
    cfg.disable_tpu()
    if bf16:
        cfg.enable_bf16()
    return jax_inference.create_predictor(cfg)


def _port_predictor(model_dir, bf16=False):
    cfg = inference.Config(model_dir)
    cfg.disable_gpu()
    if bf16:
        cfg.enable_bf16()
    return inference.create_predictor(cfg)


PIPELINE_STATS = {
    "tiny_bert": {"fc_fuse": 13, "multihead_matmul_fuse": 2,
                  "conv_bn_fuse": 0},
    "serve_transformer": {"fc_fuse": 5, "multihead_matmul_fuse": 0,
                          "conv_bn_fuse": 0},
    "conv_bn_fc": {"fc_fuse": 1, "multihead_matmul_fuse": 0,
                   "conv_bn_fuse": 1},
    "digits": {"fc_fuse": 1, "multihead_matmul_fuse": 0, "conv_bn_fuse": 0},
}


@pytest.mark.parametrize("name", sorted(PIPELINE_STATS))
def test_default_pipeline_matches_the_jax_predictor(tmp_path, name):
    """A model exported by either package, served by the port's
    predictor, against the JAX predictor on the JAX export: the same
    analysis stats, the same analyzed op types, outputs within TOL."""
    pair = Pair(name)
    dirs = pair.export(str(tmp_path))
    jpred = _jax_predictor(dirs["jax"])
    want = jpred.run([pair.feed[n] for n in pair.feeds])
    jstats = jpred.analysis_stats()
    for exporter, d in dirs.items():
        pred = _port_predictor(d)
        assert pred.get_input_names() == pair.feeds
        assert pred.get_output_names() == pair.fetch
        stats = pred.analysis_stats()
        assert stats == jstats, exporter
        assert {k: stats[k]["fused"] for k in PIPELINE_STATS[name]} == \
            PIPELINE_STATS[name]
        assert _types(pred._program) == _types(jpred._program), exporter
        got = pred.run([pair.feed[n] for n in pair.feeds])
        _close(got, [np.asarray(w) for w in want])
        for out in got:
            assert np.isfinite(out).all()


@pytest.mark.parametrize("name", ["fc_net", "tiny_bert", "tied_embedding"])
def test_bf16_predictor_matches_the_jax_predictor(tmp_path, name):
    """``enable_bf16()``: the same casts and folded weights as the JAX
    predictor, outputs within BF16_TOL of its (relative to the largest
    output), and within BF16_TOL of the port's float32 predictor."""
    pair = Pair(name)
    dirs = pair.export(str(tmp_path))
    jpred = _jax_predictor(dirs["jax"], bf16=True)
    feed = [pair.feed[n] for n in pair.feeds]
    want = [np.asarray(w, np.float32) for w in jpred.run(feed)]
    pred = _port_predictor(dirs["port"], bf16=True)
    f32 = _port_predictor(dirs["port"]).run(feed)
    got = pred.run(feed)
    assert pred.analysis_stats() == jpred.analysis_stats()
    assert _types(pred._program) == _types(jpred._program)
    assert "cast" in _types(pred._program)
    bf16 = sorted(n for n in pred._scope.var_names()
                  if pred._scope.find_var(n).dtype == torch.bfloat16)
    assert bf16 and bf16 == sorted(
        n for n in jpred._scope.var_names()
        if str(jpred._scope.find_var(n).dtype) == "bfloat16")
    assert sorted(pred._scope.var_names()) == sorted(jpred._scope.var_names())
    for g, w, f in zip(got, want, f32):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_TOL * scale)
        np.testing.assert_allclose(g, f, rtol=0, atol=BF16_TOL * scale)
    if name == "tied_embedding":
        # the lookup still reads the float32 table; the product its cast
        assert pred._scope.find_var("tied_emb").dtype == torch.float32
        assert pred._scope.find_var(
            "tied_emb.cast_bfloat16").dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the predictor's surface
# ---------------------------------------------------------------------------


def test_predictor_handles_clone_buckets_and_counters(tmp_path):
    pair = Pair("fc_net")
    d = pair.export(str(tmp_path))["port"]
    x = pair.feed["x"]
    want = pair.run_port(pair.tmain.clone(for_test=True))[0]
    pred = _port_predictor(d)
    assert pred.get_input_tensor_shape() == {"x": [-1, 8]}
    # handle-style (zero-copy) API: the output stays a tensor until copied
    pred.get_input_handle("x").copy_from_cpu(x)
    assert pred.zero_copy_run()
    handle = pred.get_output_handle(pair.fetch[0])
    assert isinstance(handle.value(), torch.Tensor)
    np.testing.assert_array_equal(handle.copy_to_cpu(), want)
    assert handle.shape() == [5, 4]
    np.testing.assert_array_equal(pred.run([x])[0], want)
    assert pred.cache_stats() == {"hits": 1, "misses": 1,
                                  "compile_s": pred.cache_stats()["compile_s"],
                                  "persistent_hits": 0}
    pred.run([np.zeros((9, 8), "float32")])
    assert len(pred._cache) == 2  # a new batch bucket
    # clones share weights, buckets and counters; handles are their own
    twin = pred.clone()
    assert twin._scope is pred._scope and twin._cache is pred._cache
    assert twin._exe is not pred._exe
    np.testing.assert_array_equal(twin.run([x])[0], want)
    assert pred.cache_stats()["hits"] == 2
    pred.get_input_handle("x").copy_from_cpu(np.zeros((5, 8), "float32"))
    assert not np.array_equal(pred.get_input_handle("x").value(),
                              twin.get_input_handle("x").value())
    # run_batch: dict in, dict out
    out = twin.run_batch({"x": x})
    np.testing.assert_array_equal(out[pair.fetch[0]], want)
    # reshape() views a flat buffer through the declared shape
    h = twin.get_input_handle("x")
    h.reshape([5, 8])
    h.copy_from_cpu(x.reshape(-1))
    np.testing.assert_array_equal(twin.run()[0], want)
    assert pred.try_shrink_memory() and len(pred._cache) == 0


def test_predictor_warmup_prepares_every_bucket(tmp_path):
    pair = Pair("serve_transformer")
    d = pair.export(str(tmp_path))["port"]
    cfg = inference.Config(d)
    cfg.disable_gpu()
    cfg.set_serving_buckets([1, 2], seq_lens=[4, 8])
    pred = inference.create_predictor(cfg)
    prepared = pred.warmup()
    assert [sig for sig, _ in prepared] == [
        (((b, s), "int64"), ((b, s), "float32"))
        for b in (1, 2) for s in (4, 8)]
    assert all(seconds > 0 for _, seconds in prepared)
    assert pred.cache_stats()["misses"] == 4 and pred.warmup() == []
    pred.run_batch({"ids": np.ones((2, 8), "int64"),
                    "mask": np.ones((2, 8), "float32")})
    assert pred.cache_stats()["misses"] == 4
    assert pred.cache_stats()["hits"] == 1


def test_save_optim_model_round_trip(tmp_path):
    pair = Pair("conv_bn_fc")
    d = pair.export(str(tmp_path))["port"]
    pred = _port_predictor(d)
    want = pred.run([pair.feed["img"]])[0]
    opt_dir = os.path.join(str(tmp_path), "optim")
    pred.save_optim_model(opt_dir)
    cfg = inference.Config(opt_dir)
    cfg.disable_gpu()
    cfg.switch_ir_optim(False)  # already analyzed
    again = inference.create_predictor(cfg)
    assert _types(again._program) == _types(pred._program)
    np.testing.assert_array_equal(again.run([pair.feed["img"]])[0], want)
    # the JAX predictor reads the port's analyzed model too
    jcfg = jax_inference.Config(opt_dir)
    jcfg.disable_tpu()
    jcfg.switch_ir_optim(False)
    np.testing.assert_allclose(
        jax_inference.create_predictor(jcfg).run([pair.feed["img"]])[0],
        want, rtol=TOL, atol=TOL)


def test_a_run_writes_nothing_into_the_shared_scope(tmp_path):
    """Replicas share one scope: batch_norm's MeanOut / VarianceOut and
    every other persistable output stay in the run."""
    pair = Pair("conv_bn")
    d = pair.export(str(tmp_path))["port"]
    cfg = inference.Config(d)
    cfg.disable_gpu()
    cfg.delete_pass("conv_bn_fuse")  # keep the batch_norm op
    pred = inference.create_predictor(cfg)
    assert "batch_norm" in _types(pred._program)
    before = {n: pred._scope.find_var(n) for n in pred._scope.var_names()}
    copies = {n: v.clone() for n, v in before.items()}
    pred.run([pair.feed["img"]])
    after = {n: pred._scope.find_var(n) for n in pred._scope.var_names()}
    assert after.keys() == before.keys()
    assert all(after[n] is before[n] and torch.equal(after[n], copies[n])
               for n in before)


def test_config_passes_and_precision():
    cfg = inference.Config("/nonexistent")
    assert cfg.use_gpu() and cfg.use_tpu()
    assert cfg.analysis_passes() == list(inference.predictor.DEFAULT_PASSES)
    cfg.delete_pass("fold_constants")
    assert "fold_constants" not in cfg.analysis_passes()
    cfg.set_precision(inference.PrecisionType.Half)
    assert cfg.precision() == "bfloat16"
    assert cfg.analysis_passes()[-1] == "bf16_cast"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg.set_precision(inference.PrecisionType.Int8)
    assert any("int8" in str(x.message) for x in w)
    assert cfg.analysis_passes()[-1] == "bf16_cast"
    cfg.set_passes(["fc_fuse"])
    assert cfg.analysis_passes() == ["fc_fuse"]
    jcfg = jax_inference.Config("/nonexistent")
    assert list(inference.predictor.DEFAULT_PASSES) == \
        jcfg.analysis_passes()


def test_a_predictor_without_a_card_raises(tmp_path, monkeypatch):
    """No CPU fallback: without ``disable_gpu()`` the predictor asks for
    the card, and with none it raises."""
    pair = Pair("fc_net")
    d = pair.export(str(tmp_path))["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EnforceError, match="CUDA"):
        inference.create_predictor(inference.Config(d))
