"""The predictor and the ServingEngine on the card: an exported tiny BERT
(unfused attention, dropouts 0.1) served through the default passes runs
``multihead_matmul_fuse``'s attention on K1 (its bf16 build under
``enable_bf16()``), agrees with the exported program run by the executor
with the kernels off, keeps an all-masked padded row finite, writes
nothing into the shared scope, serves batched requests on two
replicas within the float32 bar of single-request, and names the first
op whose rows part from single-request under padding.

Marked ``cuda``: it skips without a card and runs on one with

    python -m pytest --noconftest -m cuda tests/test_torch_inference_cuda.py -q
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference, io, kernels
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.utils import unique_name

pytestmark = pytest.mark.cuda

SEQ = 32
#: K1 (3xTF32 products, tiles) against the composite (cuBLAS float32 and
#: one softmax) through 2 layers: float32 rounding, about 1e-6
TOL = 1e-4
FEEDS = ["input_ids", "token_type_ids", "input_mask"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bert.BertConfig.tiny()
    main, startup = pt.Program(), pt.Program()
    with unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.data("input_ids", [-1, SEQ], dtype="int64")
        tt = pt.data("token_type_ids", [-1, SEQ], dtype="int64")
        mask = pt.data("input_mask", [-1, SEQ], dtype="int64")
        outs = list(bert.bert_encoder(ids, tt, mask, cfg, SEQ))
    startup.random_seed = 5
    d = str(tmp_path_factory.mktemp("bert"))
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(d, FEEDS, outs, exe, main_program=main)
    return d


def _feed(rows, lens, seed=0):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, 1024, (rows, SEQ)).astype("int64"),
            "token_type_ids": rng.randint(0, 2, (rows, SEQ)).astype("int64"),
            "input_mask": (np.arange(SEQ)[None] < np.asarray(lens)[:, None]
                           ).astype("int64")}


def _composite(model_dir, feed):
    exe, scope = pt.Executor(), pt.Scope()
    with pt.scope_guard(scope):
        program, _, fetch_vars = io.load_inference_model(model_dir, exe)
    with kernels.scoped_mode("off"):
        return exe.run(program, feed=feed, fetch_list=fetch_vars, scope=scope)


def test_the_predictor_runs_attention_on_k1(model_dir):
    pred = inference.create_predictor(inference.Config(model_dir))
    assert pred._device.type == "cuda"
    assert pred.analysis_stats()["multihead_matmul_fuse"] == {"fused": 2}
    feed = _feed(4, [SEQ, 9, 1, 0])  # the last row: every key masked
    pred.run([feed[n] for n in FEEDS])
    kernels.reset_launches()
    got = pred.run([feed[n] for n in FEEDS])
    launched = {n: c for n, c in kernels.launches().items() if c}
    assert launched == {"flash_attention_fwd": 2}
    for g, w in zip(got, _composite(model_dir, feed)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_bf16_runs_the_bf16_build(model_dir):
    config = inference.Config(model_dir)
    config.enable_bf16()
    pred = inference.create_predictor(config)
    feed = _feed(2, [SEQ, 5])
    pred.run([feed[n] for n in FEEDS])
    kernels.reset_launches()
    got = pred.run([feed[n] for n in FEEDS])
    launched = {n: c for n, c in kernels.launches().items() if c}
    assert launched == {"flash_attention_fwd_bf16": 2}
    f32 = inference.create_predictor(inference.Config(model_dir)).run(
        [feed[n] for n in FEEDS])
    for g, w in zip(got, f32):
        assert np.sqrt(((g - w) ** 2).mean() / (w ** 2).mean()) < 3e-2


def test_a_worker_thread_runs_in_inference_mode_and_writes_no_weight(
        model_dir):
    pred = inference.create_predictor(inference.Config(model_dir))
    before = {n: pred._scope.find_var(n) for n in pred._scope.var_names()}
    copies = {n: v.clone() for n, v in before.items()}
    feed = _feed(2, [SEQ, 3])
    seen = {}

    def worker():
        replica = pred.clone()
        for n in FEEDS:
            replica.get_input_handle(n).copy_from_cpu(feed[n])
        replica.zero_copy_run()
        seen["inference"] = all(
            torch.is_inference(replica.get_output_handle(n).value())
            for n in replica.get_output_names())

    t = threading.Thread(target=worker)  # grad mode is thread-local
    t.start()
    t.join()
    assert seen == {"inference": True}
    after = {n: pred._scope.find_var(n) for n in pred._scope.var_names()}
    assert all(after[n] is before[n] and torch.equal(after[n], copies[n])
               for n in before)


def test_two_replicas_serve_within_the_bar_of_single_request(model_dir):
    config = inference.Config(model_dir)
    config.set_serving_buckets([1, 2, 4, 8])
    eng = ServingEngine(config, num_replicas=2, max_wait_ms=5.0)
    ref = inference.create_predictor(inference.Config(model_dir))
    reqs = [_feed(1 + i % 3, np.random.RandomState(i).randint(
        1, SEQ + 1, 1 + i % 3), seed=i) for i in range(16)]
    refs = [ref.run_batch(r) for r in reqs]
    eng.start()
    try:
        kernels.reset_launches()
        resps = [eng.submit(r) for r in reqs]
        for r, want in zip(resps, refs):
            got = r.result(timeout=60)
            for n in want:
                np.testing.assert_allclose(got[n], want[n], rtol=TOL,
                                           atol=TOL)
        assert kernels.launches("flash_attention_fwd") > 0
    finally:
        eng.shutdown()
    st = eng.stats()
    assert st["cache_misses"] == 0 and st["completed"] == len(reqs)


def test_where_padded_rows_part_from_single_request_on_the_card(model_dir):
    """The padded-bits fault on the card (ROADMAP queue C): op by op over
    the analyzed program, each request alone and at the top of an 8-row
    batch of masked padding. Every request whose answer differs first
    differs at a GEMM (``fc``, ``matmul``; cuBLAS picks its kernel by M)
    or at the attention's softmax, never at K1, whose rows do not depend
    on the batch."""
    from test_torch_serving import _first_differing_op

    pred = inference.create_predictor(inference.Config(model_dir))
    program, block = pred._program, pred._program.global_block()
    outs = [op.output_names()[0] for op in block.ops]
    exe = pt.Executor()

    def run_all(feed):
        return exe.run(program, feed=feed, fetch_list=outs,
                       scope=pred._scope)

    firsts = []
    for trial in range(6):
        rows = 1 + trial % 3
        single = _feed(rows, np.random.RandomState(trial).randint(
            1, SEQ + 1, rows), seed=trial)
        padded = {n: np.zeros((8, SEQ), "int64") for n in single}
        for n in single:
            padded[n][:rows] = single[n]
        firsts.append(_first_differing_op(run_all, block, single, padded,
                                          rows, SEQ))
    print(f"first differing ops under padding: {firsts}")
    assert set(firsts) <= {None, "fc", "matmul", "softmax"}, firsts
