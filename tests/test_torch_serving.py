"""The batching ServingEngine of the PyTorch port on the CPU: the JAX
package's engine semantics (``tests/test_serving.py``, without the C-ABI
tests, and the breaker cycle of ``tests/test_resilience.py``) held by
the port's bucket lattice, batcher, queue, engine and predictor.

Served against single-request: the JAX tests assert bits, which the
reference does not deliver (a GEMM's row bits depend on the batch shape:
``test_engine_mixed_fixed_and_variable_feeds`` and
``test_serving_engine_acceptance_64_concurrent`` miss by one ulp on XLA's
CPU). The port holds each served output within ``SERVED_TOL`` of its own
single-request predictor and reports how many came out bit-equal.

Models are the JAX tests' (tiny per-position heads), built with the
port's layers, plus tiny BERT's exported encoder, whose fixed sequence
length makes its lattice batch-only: padding is in the mask, and a
padded row's every key is masked.
"""

import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference
from paddle_tpu_torch.core.ir import Program, program_guard
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (BatchPlan, BucketLattice,
                                      DeadlineExceededError, DynamicBatcher,
                                      Priority, RejectedError, Request,
                                      RequestError, RequestQueue,
                                      ServingEngine)
from paddle_tpu_torch.utils import unique_name

#: served (padded, batched) against single-request, float32
SERVED_TOL = 1e-6


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


def _export(model_dir, build, feeds):
    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        targets = build()
    exe = pt.Executor(place=pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_inference_model(model_dir, feeds, targets, exe,
                                   main_program=main)
    return model_dir


def _save_fixed_model(tmpdir, feat=8):
    def build():
        x = pt.data("x", [-1, feat])
        return [pt.layers.fc(pt.layers.fc(x, 16, act="relu"), 4)]
    return _export(os.path.join(str(tmpdir), "fixed"), build, ["x"])


def _save_seq_model(tmpdir, feat=4):
    """Variable-length axis: x is [-1, -1, feat], per-token fc head."""
    def build():
        x = pt.data("x", [-1, -1, feat])
        h = pt.layers.fc(x, 8, act="relu", num_flatten_dims=2)
        return [pt.layers.fc(h, 3, num_flatten_dims=2)]
    return _export(os.path.join(str(tmpdir), "seq"), build, ["x"])


def _cpu_config(model_dir):
    config = inference.Config(model_dir)
    config.disable_gpu()
    return config


def _held(got, want, counts):
    """``got`` within SERVED_TOL of ``want``; counts bit-equal answers."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=SERVED_TOL)
    counts["bit_equal"] += int(np.array_equal(got, want))
    counts["total"] += 1


# ---------------------------------------------------------------------------
# bucket lattice and batcher
# ---------------------------------------------------------------------------


def test_lattice_bucket_selection_total_and_deterministic():
    lat = BucketLattice(batch_sizes=(1, 2, 4, 8), seq_lens=(4, 8, 16))
    for rows in range(1, 9):
        b = lat.bucket_rows(rows)
        assert b == min(x for x in lat.batch_sizes if x >= rows)
        assert lat.bucket_rows(rows) == b  # deterministic
    for ln in range(1, 17):
        assert lat.bucket_len(ln) == min(x for x in lat.seq_lens if x >= ln)
    with pytest.raises(RejectedError):
        lat.bucket_rows(9)
    with pytest.raises(RejectedError):
        lat.bucket_len(17)
    pow2 = BucketLattice.pow2(12, max_seq=40)
    assert pow2.batch_sizes == (1, 2, 4, 8) and pow2.seq_lens == (8, 16, 32)
    assert BucketLattice.pow2(32).seq_lens is None


def test_lattice_classify_group_keys():
    lat = BucketLattice(batch_sizes=(1, 2, 4), seq_lens=(4, 8))
    ra, la, ka = lat.classify({"x": np.zeros((2, 3, 5), "float32")})
    rb, lb, kb = lat.classify({"x": np.zeros((1, 7, 5), "float32")})
    assert (ra, la) == (2, 3) and (rb, lb) == (1, 7)
    assert ka == kb  # different lengths batch together
    _, _, kc = lat.classify({"x": np.zeros((1, 3, 5), "int64")})
    assert kc != ka  # dtype is part of the key
    _, _, kd = lat.classify({"x": np.zeros((1, 3, 6), "float32")})
    assert kd != ka  # so are trailing non-padded dims
    with pytest.raises(RejectedError):
        lat.classify({"x": np.zeros((2, 3), "float32"),
                      "y": np.zeros((3, 1), "float32")})


def test_lattice_classify_respects_declared_fixed_dims():
    lat = BucketLattice(batch_sizes=(1, 2, 4), seq_lens=(4, 8))
    inputs = {"ids": np.zeros((2, 6), "int64"),
              "dense": np.zeros((2, 6), "float32")}
    _, vl_all, key_all = lat.classify(inputs)
    assert vl_all == 6 and all(t == (None,) for _, _, t in key_all)
    _, vl, key = lat.classify(inputs, var_feeds={"ids"})
    assert vl == 6
    key_by_name = {n: t for n, _, t in key}
    assert key_by_name == {"ids": (None,), "dense": (6,)}


def test_batcher_padding_masked_out_of_outputs():
    lat = BucketLattice(batch_sizes=(1, 2, 4), seq_lens=(4, 8))
    # "table" is a fixed [4, 2] output: its first dim equals the bucket,
    # but it is declared fixed and reaches every request whole
    batcher = DynamicBatcher(lat, feed_specs={"x": [-1, -1, 2]},
                             fetch_specs={"out": [-1, -1, 2],
                                          "table": [4, 2]})

    def mk(rid, rows, ln):
        return Request(rid, {"x": np.full((rows, ln, 2), rid, "float32")},
                       rows, 1, None, ("key",), ln)

    r1, r2 = mk(1.0, 2, 3), mk(2.0, 1, 4)
    plan = BatchPlan([r1, r2], bucket_rows=4, bucket_len=4)
    assert plan.real_rows == 3 and plan.occupancy == 0.75
    feeds = batcher.assemble(plan)
    assert feeds["x"].shape == (4, 4, 2)
    assert (feeds["x"][0:2, 0:3] == 1.0).all()
    assert (feeds["x"][0:2, 3:] == 0.0).all()  # r1's padded positions
    assert (feeds["x"][2:3] == 2.0).all()
    assert (feeds["x"][3:] == 0.0).all()  # dummy row
    table = np.arange(8, dtype="float32").reshape(4, 2)
    outs = batcher.scatter(plan, {"out": feeds["x"] * 10.0,
                                  "table": table})
    assert outs[0]["out"].shape == (2, 3, 2)  # rows AND length sliced
    assert all(np.array_equal(o["table"], table) for o in outs)
    assert (outs[0]["out"] == 10.0).all()
    assert outs[1]["out"].shape == (1, 4, 2) and (outs[1]["out"] == 20.0).all()


def test_batcher_plans_and_wait_hint():
    """plan() waits for a full bucket or the head's max wait; gathers only
    group-compatible requests that fit the head's length bucket."""
    lat = BucketLattice(batch_sizes=(1, 2, 4), seq_lens=(4, 8))
    batcher = DynamicBatcher(lat, feed_specs={}, fetch_specs={},
                             max_wait_s=0.05)
    q = RequestQueue(max_depth=16)
    now = time.perf_counter()

    def put(rid, rows, ln, key=("k",)):
        r = Request(rid, {}, rows, Priority.NORMAL, None, key, ln)
        r.submit_time = now
        q.put(r)

    put(1, 1, 3)
    put(2, 1, 7)           # longer than the head's bucket of 4: waits
    put(3, 2, 2)
    put(4, 1, 2, ("other",))
    assert batcher.plan(q, now=now) is None  # neither full nor aged
    assert 0.0 < batcher.wait_hint(q, now=now) <= 0.05
    plan = batcher.plan(q, now=now + 0.06)   # aged
    assert [r.id for r in plan.requests] == [1, 3]
    assert (plan.bucket_rows, plan.bucket_len) == (4, 4)
    assert [r.id for r in q.iter_requests()] == [2, 4]


# ---------------------------------------------------------------------------
# queue: admission control
# ---------------------------------------------------------------------------


def test_queue_backpressure_and_priority_lanes():
    q = RequestQueue(max_depth=4)

    def mk(rid, prio, rows=1):
        return Request(rid, {}, rows, prio, None, ("k",), 0)

    q.put(mk(1, Priority.LOW))
    q.put(mk(2, Priority.NORMAL))
    q.put(mk(3, Priority.HIGH))
    assert q.head().id == 3  # high lane drains first
    with pytest.raises(RejectedError) as ei:
        q.put(mk(4, Priority.NORMAL, rows=2))  # 3 + 2 > 4
    assert ei.value.code == "rejected" and ei.value.retry_after_s >= 0.0
    assert ei.value.to_dict()["code"] == "rejected"
    q.close()
    with pytest.raises(RejectedError):
        q.put(mk(5, Priority.HIGH))
    assert [r.id for r in q.iter_requests()] == [3, 2, 1]


def test_queue_deadline_expiry_before_dispatch():
    q = RequestQueue(max_depth=8)
    now = time.perf_counter()
    q.put(Request(1, {}, 1, 1, now + 60.0, ("k",), 0))
    q.put(Request(2, {}, 1, 1, now - 0.001, ("k",), 0))
    assert [r.id for r in q.expire()] == [2]
    assert [r.id for r in q.iter_requests()] == [1]
    assert q.depth() == 1


# ---------------------------------------------------------------------------
# engine: warmup, admission validation, isolation, drain
# ---------------------------------------------------------------------------


def test_engine_warmup_covers_every_bucket(tmp_path):
    config = _cpu_config(_save_seq_model(tmp_path))
    config.set_serving_buckets([1, 2, 4], seq_lens=[4, 8])
    eng = ServingEngine(config, num_replicas=2)
    eng.start()
    try:
        assert len(eng.predictor._cache) == 6
        assert eng.predictor.cache_stats()["misses"] == 6
        assert eng._replicas[1]._cache is eng.predictor._cache
        r = eng.submit({"x": np.ones((3, 5, 4), "float32")})
        assert r.result(timeout=30)[eng.predictor.get_output_names()[0]] \
            .shape == (3, 5, 3)
    finally:
        eng.shutdown()
    st = eng.stats()
    assert st["cache_misses"] == 0 and st["cache_hit_rate"] == 1.0
    assert st["batch_buckets"] == [1, 2, 4] and st["seq_buckets"] == [4, 8]


def test_engine_needs_a_lattice(tmp_path):
    with pytest.raises(ValueError):
        ServingEngine(_cpu_config(_save_fixed_model(tmp_path)))


def test_engine_admission_validation(tmp_path):
    config = _cpu_config(_save_fixed_model(tmp_path))
    config.set_serving_buckets([1, 2, 4])
    eng = ServingEngine(config, queue_depth=8)
    cases = [
        {"wrong": np.zeros((1, 8), "float32")},       # names
        {"x": np.zeros((1, 8), "float64")},           # dtype
        {"x": np.zeros((1, 9), "float32")},           # trailing dim
        {"x": np.zeros((1, 2, 8), "float32")},        # rank
        {"x": np.zeros((5, 8), "float32")},           # rows beyond lattice
        [np.zeros((1, 8), "float32")],                # not a dict
    ]
    for inputs in cases:
        with pytest.raises(RejectedError):
            eng.submit(inputs)
    with pytest.raises(RejectedError):
        eng.submit({"x": np.zeros((1, 8), "float32")}, priority=7)
    assert eng.metrics.count("rejected_invalid") == len(cases) + 1
    assert eng.metrics.count("rejected") == len(cases) + 1
    assert eng.metrics.count("admitted") == 0


def test_engine_queue_full_backpressure(tmp_path):
    config = _cpu_config(_save_fixed_model(tmp_path))
    config.set_serving_buckets([1, 2])
    eng = ServingEngine(config, queue_depth=3)
    for _ in range(3):  # workers not started: the queue fills
        eng.submit({"x": np.zeros((1, 8), "float32")})
    with pytest.raises(RejectedError) as ei:
        eng.submit({"x": np.zeros((1, 8), "float32")})
    assert ei.value.code == "rejected" and ei.value.retry_after_s > 0.0
    assert eng.metrics.count("rejected_queue_full") == 1
    assert eng.metrics.count("admitted") == 3


def test_engine_poison_request_isolated(tmp_path, rng):
    """A request that faults its batch is re-run alone and fails alone;
    batchmates are served from the isolation re-run."""
    model_dir = _save_fixed_model(tmp_path)
    config = _cpu_config(model_dir)
    config.set_serving_buckets([1, 2, 4])
    eng = ServingEngine(config, num_replicas=1, queue_depth=32,
                        max_wait_ms=20.0)
    POISON = 6.66e6
    real_run_batch = type(eng.predictor).run_batch

    def poisoned_run_batch(self, feeds):
        if (feeds["x"] == POISON).any():
            raise RuntimeError("device fault in batch")
        return real_run_batch(self, feeds)

    eng.predictor.run_batch = poisoned_run_batch.__get__(eng.predictor)
    ref_pred = inference.create_predictor(_cpu_config(model_dir))
    good_in = [rng.randn(1, 8).astype("float32") for _ in range(3)]
    refs = [ref_pred.run([g])[0] for g in good_in]
    eng.start()
    try:
        resps = [eng.submit({"x": g}) for g in good_in]
        bad = eng.submit({"x": np.full((1, 8), POISON, "float32")})
        out_name = eng.predictor.get_output_names()[0]
        counts = {"bit_equal": 0, "total": 0}
        for r, ref in zip(resps, refs):
            _held(r.result(timeout=30)[out_name], ref, counts)
        with pytest.raises(RequestError) as ei:
            bad.result(timeout=30)
        assert ei.value.code == "request_failed"
        assert eng.metrics.count("failed") == 1
        assert eng.metrics.count("completed") == 3
        assert eng.metrics.count("batch_failures") >= 1
    finally:
        eng.shutdown()


def test_engine_fault_site_fails_the_batch_and_isolation_serves_it(tmp_path):
    """The ``serving.run_batch`` fault site: one injected fault fails the
    batch; each request's isolated re-run then serves it."""
    config = _cpu_config(_save_fixed_model(tmp_path))
    config.set_serving_buckets([1, 2, 4])
    eng = ServingEngine(config, num_replicas=1, max_wait_ms=20.0)
    eng.start()
    try:
        faults.configure([{"site": "serving.run_batch", "action": "raise",
                           "times": 1}])
        resps = [eng.submit({"x": np.ones((1, 8), "float32")})
                 for _ in range(3)]
        outs = [r.result(timeout=30) for r in resps]
        fired = sum(r["fired"] for r in
                    faults.get_injector().rule_stats().values())
    finally:
        faults.reset()
        eng.shutdown()
    assert fired == 1 and len(outs) == 3
    st = eng.stats()
    assert st["batch_failures"] == 1 and st["failed"] == 0
    assert st["completed"] == 3


def test_engine_deadline_missed_rejected_before_dispatch(tmp_path):
    config = _cpu_config(_save_fixed_model(tmp_path))
    config.set_serving_buckets([1, 2])
    eng = ServingEngine(config, queue_depth=8, max_wait_ms=30.0)
    dead = [eng.submit({"x": np.zeros((1, 8), "float32")}, deadline_ms=0)
            for _ in range(2)]
    live = eng.submit({"x": np.zeros((1, 8), "float32")})
    time.sleep(0.002)
    eng.start()
    try:
        assert live.result(timeout=30) is not None
        for d in dead:
            with pytest.raises(DeadlineExceededError) as ei:
                d.result(timeout=30)
            assert ei.value.code == "deadline"
        assert eng.metrics.count("deadline_missed") == 2
        assert eng.metrics.count("completed") == 1
    finally:
        eng.shutdown()


def test_engine_graceful_drain(tmp_path):
    config = _cpu_config(_save_fixed_model(tmp_path))
    config.set_serving_buckets([1, 2, 4])
    eng = ServingEngine(config, queue_depth=64, max_wait_ms=2.0)
    eng.start()
    resps = [eng.submit({"x": np.zeros((1, 8), "float32")})
             for _ in range(12)]
    eng.shutdown()  # drain: every admitted request still gets an answer
    assert all(r.done() and r.error() is None for r in resps)
    with pytest.raises(RejectedError) as ei:
        eng.submit({"x": np.zeros((1, 8), "float32")})
    assert ei.value.retry_after_s == 0.0
    assert eng.metrics.count("rejected_shutdown") == 1


def test_breaker_quarantines_and_readmits(tmp_path, rng):
    """K failed batches open the replica's breaker; a request submitted
    during the cooldown is served by the probe, which closes it; a relapse
    re-opens it through a failed probe; healing re-admits it."""
    config = _cpu_config(_save_fixed_model(tmp_path, feat=4))
    lattice = BucketLattice([1, 2])
    config.set_serving_buckets(lattice.batch_sizes, lattice.seq_lens)
    K = 2
    engine = ServingEngine(config, lattice=lattice, num_replicas=1,
                           max_wait_ms=1.0, breaker_threshold=K,
                           breaker_cooldown_s=0.4)
    engine.start()
    try:
        rep = engine._replicas[0]
        healthy_run = rep.run_batch

        def broken(feeds):
            raise RuntimeError("forced replica failure")

        x = rng.randn(1, 4).astype("float32")
        rep.run_batch = broken
        for _ in range(K):
            with pytest.raises(RequestError):
                engine.submit({"x": x}).result(timeout=30)
        stats = engine.stats()
        assert stats["batch_failures"] == K and stats["failed"] == K
        assert stats["breaker_opened"] == 1
        assert stats["breaker_states"] == ["open"]
        assert stats["breaker_open_replicas"] == 1

        rep.run_batch = healthy_run
        t0 = time.perf_counter()
        out = engine.submit({"x": x}).result(timeout=30)
        assert time.perf_counter() - t0 >= 0.2  # sat out the cooldown
        np.testing.assert_array_equal(
            out[engine.predictor.get_output_names()[0]],
            engine.predictor.run([x])[0])
        stats = engine.stats()
        assert stats["breaker_probes"] == 1 and stats["breaker_closed"] == 1
        assert stats["breaker_states"] == ["closed"]
        assert stats["completed"] == 1

        rep.run_batch = broken
        for _ in range(K):
            with pytest.raises(RequestError):
                engine.submit({"x": x}).result(timeout=30)
        assert engine.stats()["breaker_opened"] == 2
        with pytest.raises(RequestError):
            engine.submit({"x": x}).result(timeout=30)  # failing probe
        stats = engine.stats()
        assert stats["breaker_probes"] == 2
        assert stats["breaker_reopened"] == 1
        assert stats["breaker_states"] == ["open"]

        rep.run_batch = healthy_run
        engine.submit({"x": x}).result(timeout=30)
        stats = engine.stats()
        assert stats["breaker_probes"] == 3 and stats["breaker_closed"] == 2
        assert stats["breaker_states"] == ["closed"]
    finally:
        engine.shutdown()


# ---------------------------------------------------------------------------
# served against single-request
# ---------------------------------------------------------------------------


def test_engine_mixed_fixed_and_variable_feeds(tmp_path, rng):
    """Variable-length ids + fixed-width dense: only the declared-variable
    axis pads, every served shape stays on the warmed lattice."""
    def build():
        ids = pt.data("ids", [-1, -1], dtype="int64")
        dense = pt.data("dense", [-1, 6])
        emb = pt.layers.embedding(ids, size=(30, 8))
        d = pt.layers.unsqueeze(pt.layers.fc(dense, 8), [1])
        h = pt.layers.elementwise_add(emb, d)  # [B,S,8] + [B,1,8]
        return [pt.layers.fc(h, 3, num_flatten_dims=2)]

    model_dir = _export(os.path.join(str(tmp_path), "mixed"), build,
                        ["ids", "dense"])
    config = _cpu_config(model_dir)
    config.set_serving_buckets([1, 2, 4], seq_lens=[4, 8])
    eng = ServingEngine(config, queue_depth=64, max_wait_ms=3.0)
    assert eng._batcher.var_feeds == {"ids"}
    ref = inference.create_predictor(_cpu_config(model_dir))
    eng.start()
    counts = {"bit_equal": 0, "total": 0}
    try:
        out_name = eng.predictor.get_output_names()[0]
        resps, refs = [], []
        for i in range(12):
            rows, ln = 1 + i % 2, 2 + i % 7
            req = {"ids": rng.randint(0, 30, (rows, ln)).astype("int64"),
                   "dense": rng.randn(rows, 6).astype("float32")}
            refs.append(ref.run([req["ids"], req["dense"]])[0])
            resps.append(eng.submit(req))
        for r, expect in zip(resps, refs):
            _held(r.result(timeout=30)[out_name], expect, counts)
    finally:
        eng.shutdown()
    st = eng.stats()
    assert st["cache_misses"] == 0, st
    assert st["completed"] == 12
    print(f"mixed feeds: {counts['bit_equal']}/{counts['total']} served "
          "outputs bit-equal to single-request")


def test_serving_engine_acceptance_64_concurrent(tmp_path, rng):
    model_dir = _save_seq_model(tmp_path)
    config = _cpu_config(model_dir)
    lattice = BucketLattice(batch_sizes=(1, 2, 4, 8), seq_lens=(4, 8))
    config.set_serving_buckets(lattice.batch_sizes, lattice.seq_lens)
    eng = ServingEngine(config, lattice=lattice, num_replicas=2,
                        queue_depth=256, max_wait_ms=4.0)
    eng.start()
    ref_pred = inference.create_predictor(_cpu_config(model_dir))
    out_name = eng.predictor.get_output_names()[0]
    n_requests = 72
    payloads = [rng.randn(int(rng.randint(1, 4)), int(rng.randint(2, 9)),
                          4).astype("float32") for _ in range(n_requests)]
    refs = [ref_pred.run([p])[0] for p in payloads]
    resps = [None] * n_requests
    submit_errors = []
    lock = threading.Lock()

    def submitter(start, step):
        for i in range(start, n_requests, step):
            try:
                resps[i] = eng.submit({"x": payloads[i]}, priority=i % 3)
            except Exception as e:  # pragma: no cover - must not happen
                with lock:
                    submit_errors.append((i, e))

    threads = [threading.Thread(target=submitter, args=(t, 8))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not submit_errors, submit_errors
    counts = {"bit_equal": 0, "total": 0}
    for r, ref in zip(resps, refs):
        _held(r.result(timeout=60)[out_name], ref, counts)
    dead = eng.submit({"x": payloads[0]}, deadline_ms=0)
    with pytest.raises(DeadlineExceededError):
        dead.result(timeout=30)
    eng.shutdown()
    with pytest.raises(RejectedError) as ei:
        eng.submit({"x": payloads[0]})
    assert ei.value.retry_after_s == 0.0
    stats = eng.stats()
    assert stats["cache_misses"] == 0 and stats["cache_hit_rate"] == 1.0
    assert stats["avg_batch_rows"] > 1.0
    assert 0.0 < stats["avg_batch_occupancy"] <= 1.0
    assert stats["completed"] == n_requests
    assert stats["admitted"] == n_requests + 1
    assert stats["deadline_missed"] == 1
    assert stats["rejected"] == 1 and stats["rejected_shutdown"] == 1
    assert stats["submitted"] == n_requests + 2
    assert stats["batches"] < n_requests
    assert stats["latency_p99_s"] >= stats["latency_p50_s"] >= 0.0
    assert stats["num_replicas"] == 2
    print(f"64 concurrent: {counts['bit_equal']}/{counts['total']} served "
          "outputs bit-equal to single-request")


def test_bert_encoder_served_batch_only_with_masked_padding(tmp_path, rng):
    """Tiny BERT's export fixes its length, so the lattice is batch-only
    and padding lives in the mask: requests with real lengths inside the
    mask, batched and padded, against single-request; a batch's dummy
    rows (every key masked) give finite outputs."""
    from paddle_tpu_torch.models import bert

    seq, cfg = 16, bert.BertConfig.tiny()

    def build():
        ids = pt.data("input_ids", [-1, seq], dtype="int64")
        tt = pt.data("token_type_ids", [-1, seq], dtype="int64")
        mask = pt.data("input_mask", [-1, seq], dtype="int64")
        return list(bert.bert_encoder(ids, tt, mask, cfg, seq))

    model_dir = _export(os.path.join(str(tmp_path), "bert"), build,
                        ["input_ids", "token_type_ids", "input_mask"])
    config = _cpu_config(model_dir)
    config.set_serving_buckets([1, 2, 4, 8])
    eng = ServingEngine(config, num_replicas=2, max_wait_ms=5.0)
    assert eng.predictor.analysis_stats()["multihead_matmul_fuse"] == {
        "fused": 2}
    assert eng._batcher.var_feeds == set()
    ref = inference.create_predictor(_cpu_config(model_dir))
    padded = ref.run_batch({
        "input_ids": np.zeros((4, seq), "int64"),
        "token_type_ids": np.zeros((4, seq), "int64"),
        "input_mask": np.zeros((4, seq), "int64")})
    assert all(np.isfinite(v).all() for v in padded.values())
    reqs = []
    for i in range(10):
        rows = 1 + i % 3
        lens = rng.randint(4, seq + 1, rows)
        reqs.append({
            "input_ids": rng.randint(0, cfg.vocab_size, (rows, seq)),
            "token_type_ids": rng.randint(0, 2, (rows, seq)),
            "input_mask": (np.arange(seq)[None] < lens[:, None])})
        reqs[-1] = {k: v.astype("int64") for k, v in reqs[-1].items()}
    refs = [ref.run_batch(r) for r in reqs]
    eng.start()
    counts = {"bit_equal": 0, "total": 0}
    try:
        resps = [eng.submit(r) for r in reqs]
        for r, want in zip(resps, refs):
            got = r.result(timeout=60)
            for n in want:
                _held(got[n], want[n], counts)
    finally:
        eng.shutdown()
    st = eng.stats()
    assert st["cache_misses"] == 0 and st["completed"] == len(reqs)
    print(f"tiny BERT: {counts['bit_equal']}/{counts['total']} served "
          "outputs bit-equal to single-request")


def test_serve_transformer_encoder_served_under_padding(tmp_path, rng):
    """``examples/serve_transformer.py``'s encoder (variable length, the
    key mask an input): padded, batched answers against single-request."""
    from test_torch_inference import serve_transformer

    model_dir = os.path.join(str(tmp_path), "encoder")
    with unique_name.guard():
        main, startup, feeds, targets = serve_transformer(pt)
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_inference_model(model_dir, feeds, targets, exe,
                                   main_program=main)
    config = _cpu_config(model_dir)
    lattice = BucketLattice(batch_sizes=(1, 2, 4, 8), seq_lens=(4, 8, 16))
    config.set_serving_buckets(lattice.batch_sizes, lattice.seq_lens)
    eng = ServingEngine(config, lattice=lattice, num_replicas=2,
                        queue_depth=128, max_wait_ms=4.0)
    ref = inference.create_predictor(_cpu_config(model_dir))
    reqs = []
    for _ in range(24):
        rows, ln = int(rng.randint(1, 3)), int(rng.randint(2, 17))
        reqs.append({"ids": rng.randint(1, 100, (rows, ln)).astype("int64"),
                     "mask": np.ones((rows, ln), "float32")})
    refs = [ref.run([r["ids"], r["mask"]])[0] for r in reqs]
    eng.start()
    counts = {"bit_equal": 0, "total": 0}
    try:
        resps = [eng.submit(r, priority=i % 3) for i, r in enumerate(reqs)]
        out_name = eng.predictor.get_output_names()[0]
        for r, want in zip(resps, refs):
            _held(r.result(timeout=60)[out_name], want, counts)
    finally:
        eng.shutdown()
    st = eng.stats()
    assert st["cache_misses"] == 0 and st["completed"] == len(reqs)
    assert st["padded_rows"] >= 0 and st["avg_batch_rows"] >= 1.0
    print(f"serve_transformer: {counts['bit_equal']}/{counts['total']} "
          "served outputs bit-equal to single-request")


# ---------------------------------------------------------------------------
# the padded-bits fault, shared with the reference
# ---------------------------------------------------------------------------


def _first_differing_op(run_all, block, single, padded, rows, ln):
    """The type of the first op of ``block`` whose request rows differ
    between the single-request run and the padded one, or None."""
    alone, batched = run_all(single), run_all(padded)
    for op, a, b in zip(block.ops, alone, batched):
        a, b = np.asarray(a), np.asarray(b)[:rows]
        if a.ndim >= 2 and b.ndim >= 2 and b.shape[1] != a.shape[1]:
            b = b[:, :ln]
        if a.shape == b.shape and not np.array_equal(a, b):
            return op.type
    return None


def test_where_the_reference_and_the_port_part_under_padding(tmp_path, rng):
    """The JAX tests that assert served == single-request bits fail by an
    ulp because a GEMM's rows depend on the batch shape. Op by op over the
    same requests, every JAX answer that differs first differs at an
    ``fc`` (an XLA dot); every port answer that differs first differs at
    a GEMM or at the attention's softmax, whose padded row sums more
    (masked) positions."""
    import paddle_tpu as fluid
    from paddle_tpu import inference as jax_inference
    from paddle_tpu.utils import unique_name as jax_names
    from test_torch_inference import serve_transformer

    def seq_model(mod):
        main, startup = mod.Program(), mod.Program()
        with mod.program_guard(main, startup):
            x = mod.data("x", [-1, -1, 4])
            h = mod.layers.fc(x, 8, act="relu", num_flatten_dims=2)
            pred = mod.layers.fc(h, 3, num_flatten_dims=2)
        return main, startup, ["x"], [pred]

    firsts = {"jax": set(), "port": set()}
    for pkg, mod, names, build in (
            ("jax", fluid, jax_names, seq_model),
            ("port", pt, unique_name, serve_transformer)):
        with names.guard():
            main, startup, feeds, targets = build(mod)
        model_dir = os.path.join(str(tmp_path), pkg)
        exe = (fluid.Executor(fluid.CPUPlace()) if pkg == "jax"
               else pt.Executor(place=pt.CPUPlace()))
        scope = mod.Scope()
        with mod.scope_guard(scope):
            exe.run(startup)
            mod.io.save_inference_model(model_dir, feeds, targets, exe,
                                        main_program=main)
        if pkg == "jax":
            config = jax_inference.Config(model_dir)
            config.disable_tpu()
            pred = jax_inference.create_predictor(config)
        else:
            pred = inference.create_predictor(_cpu_config(model_dir))
        block = pred._program.global_block()
        outs = [op.output_names()[0] for op in block.ops]

        def run_all(feed, pred=pred, exe=exe, outs=outs, mod=mod):
            with mod.scope_guard(pred._scope):
                return exe.run(pred._program, feed=feed, fetch_list=outs)

        for trial in range(6):
            rows, ln = 1 + trial % 2, 2 + trial
            if pkg == "jax":
                single = {"x": rng.randn(rows, ln, 4).astype("float32")}
            else:
                single = {"ids": rng.randint(1, 100, (rows, ln)),
                          "mask": np.ones((rows, ln), "float32")}
            padded = {}
            for n, v in single.items():
                padded[n] = np.zeros((8, 16) + v.shape[2:], v.dtype)
                padded[n][:rows, :ln] = v
            first = _first_differing_op(run_all, block, single, padded,
                                        rows, ln)
            if first is not None:
                firsts[pkg].add(first)
    assert firsts["jax"] <= {"fc"}, firsts
    assert firsts["port"] <= {"fc", "matmul", "softmax"}, firsts
    print(f"first differing ops under padding: {firsts}")
