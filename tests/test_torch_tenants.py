"""The PyTorch port's decode engine as a multi-tenant front door, against
the JAX package's engine, at a tiny size on the CPU: weighted-fair
dispatch inside the strict priority lanes (the JAX engine's dispatch
order for the same tenant mix), per-tenant quotas that reject with a
measured backoff, the circuit breaker and its relaunch, the fault sites,
the metrics surface (the JAX engine's ``stats()`` keys), and the model
lifecycle (``unregister_model``, ``reroute_queued``)."""

import time

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu.serving.decode import GenerationEngine as JaxEngine
from paddle_tpu.serving.decode import GenerationRequest as JaxRequest
from paddle_tpu.serving.decode import build_decoder_model as jax_build
from paddle_tpu.serving.queue import RequestQueue as JaxQueue
from paddle_tpu.serving.request import Priority as JaxPriority
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving.decode import GenerationEngine as TorchEngine
from paddle_tpu_torch.serving.decode import GenerationRequest
from paddle_tpu_torch.serving.decode import build_decoder_model as torch_build
from paddle_tpu_torch.serving.queue import RequestQueue
from paddle_tpu_torch.serving.request import (
    Priority,
    RejectedError,
    ReplicaLostError,
    RequestError,
)

GEOM = dict(vocab_size=32, hidden=8, num_layers=2, slots=2, max_len=16)
# the JAX engine's stats() keys an eager port cannot have
NOT_IN_PORT = {"compile_sources"}


def _param_arrays(jentry):
    m = jentry.model
    arenas = {n for kv in m.state_names for n in kv}
    return {v.name: np.asarray(jentry._scope.find_var(v.name))
            for v in m.startup_program.global_block().vars.values()
            if v.persistable and v.name not in arenas}


@pytest.fixture(scope="module")
def pair():
    """A started JAX engine serving "ten" and its weights."""
    jeng = JaxEngine(queue_depth=64, breaker_threshold=0)
    jentry = jeng.register_model(jax_build(**GEOM, name="ten"))
    jeng.start()
    yield jeng, jentry, _param_arrays(jentry)
    jeng.shutdown()


def _port(pair, name="ten", **engine_kw):
    """A port engine hosting ``name`` with the JAX entry's weights."""
    kw = dict(place=pt.CPUPlace(), queue_depth=64, breaker_threshold=0)
    kw.update(engine_kw)
    teng = TorchEngine(**kw)
    tentry = teng.register_model(torch_build(**GEOM, name=name))
    load_params(tentry.scope, {name + n[len("ten"):]: a
                               for n, a in pair[2].items()})
    return teng, tentry


def _tokens(resp):
    return [int(t) for t in resp.result(timeout=120)["tokens"]]


# ---------------------------------------------------------------------------
# weighted-fair pick: the JAX engine's order
# ---------------------------------------------------------------------------


class _Both:
    """The same queue and picker calls on both engines; every pick
    returns the port's request and asserts the JAX engine picked the
    same id."""

    def __init__(self, max_depth=256):
        self.t = TorchEngine(place=pt.CPUPlace(), breaker_threshold=0)
        self.j = JaxEngine(breaker_threshold=0)
        self.tq = RequestQueue(max_depth=max_depth)
        self.jq = JaxQueue(max_depth=max_depth)

    def set_tenant(self, *a, **kw):
        self.t.set_tenant(*a, **kw)
        self.j.set_tenant(*a, **kw)

    def tenant(self, name):
        return self.t._tenant(name), self.j._tenant(name)

    def queued(self, rid, tenant, priority=Priority.NORMAL):
        self.tq.put(GenerationRequest(rid, [1], 4, tenant, priority, None))
        jp = {Priority.HIGH: JaxPriority.HIGH,
              Priority.NORMAL: JaxPriority.NORMAL,
              Priority.LOW: JaxPriority.LOW}[priority]
        self.jq.put(JaxRequest(rid, [1], 4, tenant, jp, None))

    def pick(self):
        with self.tq.lock:
            got = self.t._pick(self.tq)
        with self.jq.lock:
            want = self.j._pick(self.jq)
        assert (got and got.id) == (want and want.id)
        return got


def test_weighted_fair_pick_honors_stride_shares():
    """A weight-2 tenant wins two dispatches for every one a weight-1
    tenant wins, in the JAX engine's order."""
    b = _Both()
    b.set_tenant("a", weight=2.0)
    b.set_tenant("b", weight=1.0)
    for i in range(60):
        b.queued(i, "a" if i % 2 == 0 else "b")
    wins = {"a": 0, "b": 0}
    for _ in range(30):
        wins[b.pick().tenant] += 1
    assert wins["a"] == 20 and wins["b"] == 10, wins


def test_weighted_fair_order_of_a_three_tenant_mix():
    """Weights 3:2:1 with queues of unequal length, HIGH and LOW traffic
    among them: the whole dispatch order equals the JAX engine's."""
    b = _Both()
    for t, w in (("x", 3.0), ("y", 2.0), ("z", 1.0)):
        b.set_tenant(t, weight=w)
    rng = np.random.RandomState(2)
    for i in range(48):
        t = "xyz"[int(rng.randint(3))]
        pr = (Priority.HIGH if i % 11 == 0 else
              Priority.LOW if i % 7 == 0 else Priority.NORMAL)
        b.queued(i, t, pr)
    order = [b.pick() for _ in range(48)]
    assert all(r is not None for r in order)
    assert b.pick() is None


def test_pick_strict_priority_lanes_before_fairness():
    """Lane order dominates: a HIGH request dispatches before NORMAL
    traffic even when its tenant is far behind on virtual time."""
    b = _Both(max_depth=64)
    b.set_tenant("busy", weight=1.0)
    for i in range(4):
        b.queued(i, "busy")
        b.pick()                   # banks virtual time for 'busy'
    b.queued(100, "fresh")                          # NORMAL lane
    b.queued(101, "busy", priority=Priority.HIGH)
    assert b.pick().id == 101


def test_pick_skips_tenant_at_in_flight_cap():
    b = _Both(max_depth=64)
    b.set_tenant("capped", weight=10.0, max_in_flight=1)
    for st in b.tenant("capped"):
        st.in_flight = 1
    b.queued(1, "capped")
    b.queued(2, "other")
    assert b.pick().tenant == "other"
    # only the capped tenant queued -> nothing admissible, req stays queued
    assert b.pick() is None
    for st in b.tenant("capped"):
        st.in_flight = 0
    assert b.pick().tenant == "capped"


def test_pick_reserves_in_flight_so_one_round_cannot_exceed_cap():
    """An admission round with several free slots calls _pick repeatedly
    BEFORE any prefill runs; the cap is charged at pick time."""
    b = _Both(max_depth=64)
    b.set_tenant("capped", weight=1.0, max_in_flight=1)
    b.queued(1, "capped")
    b.queued(2, "capped")
    first = b.pick()
    assert first.tenant == "capped"
    assert b.t._tenant("capped").in_flight == 1
    assert b.pick() is None
    b.t._tenant_unflight("capped")
    b.j._tenant_unflight("capped")
    assert b.pick().id == 2


def test_idle_tenant_reenters_at_vtime_floor():
    """A long-idle tenant must not burn banked lag into a burst that
    starves everyone else: it re-enters at the current floor and still
    alternates with the active tenant."""
    b = _Both()
    b.set_tenant("active", weight=1.0)
    b.set_tenant("idle", weight=1.0)
    for i in range(10):
        b.queued(i, "active")
        b.pick()                   # active's vtime climbs to 10
    for i in range(10, 18):
        b.queued(i, "active" if i % 2 == 0 else "idle")
    picks = [b.pick().tenant for _ in range(8)]
    for k in range(len(picks) - 2):
        assert len(set(picks[k:k + 3])) > 1, picks


def test_tenants_share_a_full_engine_by_weight(pair):
    """Two tenants weighted 3:1 behind a full queue of a hand-stepped
    engine: dispatches go 3:1 while both have work, and every stream
    equals the JAX engine's offline reference."""
    _jeng, jentry, _arrays = pair
    teng, tentry = _port(pair, name="share")
    teng.set_tenant("gold", weight=3.0)
    teng.set_tenant("free", weight=1.0)
    prompts = {}
    resps = []
    for i in range(16):
        tenant = "gold" if i % 2 == 0 else "free"
        p = [1 + i % 7, 2 + i % 5, 3]
        r = teng.submit(p, tenant=tenant, max_new_tokens=3)
        prompts[id(r)] = p
        resps.append((tenant, r))
    order = []
    orig = teng._pick

    def spy(queue, **kw):
        req = orig(queue, **kw)
        if req is not None:
            order.append(req.tenant)
        return req

    teng._pick = spy
    for _ in range(400):
        if all(r.done() for _t, r in resps):
            break
        tentry._iterate()
    first8 = order[:8]
    assert first8.count("gold") == 6 and first8.count("free") == 2, order
    for _t, r in resps:
        assert _tokens(r) == jentry.offline_decode(prompts[id(r)], 3)
    st = teng.stats()["tenants"]
    assert st["gold"]["in_flight"] == st["free"]["in_flight"] == 0
    assert st["gold"]["queued"] == st["free"]["queued"] == 0
    assert tentry.stats()["tenant_completed"] == {"gold": 8, "free": 8}


def test_tenant_admission_quota_rejects_with_measured_backoff(pair):
    teng, tentry = _port(pair, name="quota")
    teng.set_tenant("small", max_queued=2)
    # engine NOT started: submissions stay queued
    teng.submit([1, 2], tenant="small", max_new_tokens=2)
    teng.submit([1, 2], tenant="small", max_new_tokens=2)
    with pytest.raises(RejectedError) as exc:
        teng.submit([1, 2], tenant="small", max_new_tokens=2)
    assert "quota" in str(exc.value)
    assert exc.value.retry_after_s > 0.0
    assert tentry.metrics.count("rejected_quota") == 1
    assert teng.stats()["tenants"]["small"]["queued"] == 2
    # the JAX engine's message for the same quota
    jeng = JaxEngine(queue_depth=16, breaker_threshold=0)
    jeng.register_model(jax_build(**GEOM, name="quota"))
    jeng.set_tenant("small", max_queued=2)
    jeng.submit([1, 2], tenant="small", max_new_tokens=2)
    jeng.submit([1, 2], tenant="small", max_new_tokens=2)
    with pytest.raises(Exception) as jexc:
        jeng.submit([1, 2], tenant="small", max_new_tokens=2)
    assert str(jexc.value) == str(exc.value)


def test_quota_reject_on_live_engine_does_not_deadlock(pair):
    """Over-quota submits while the scheduler loop dispatches: the quota
    path estimates retry-after outside the tenant lock."""
    teng, tentry = _port(pair, name="livequota")
    teng.set_tenant("q", max_queued=1)
    teng.start()
    try:
        keep = [teng.submit([1, 2], tenant="q", max_new_tokens=12)]
        rejected = 0
        for _ in range(200):
            try:
                keep.append(teng.submit([1, 2], tenant="q",
                                        max_new_tokens=2))
            except RejectedError as e:
                assert e.retry_after_s > 0.0
                rejected += 1
        assert rejected > 0
        for r in keep:
            r.result(timeout=120)
    finally:
        teng.shutdown()
    assert tentry.metrics.count("rejected_quota") == rejected


# ---------------------------------------------------------------------------
# fault sites, circuit breaker, relaunch
# ---------------------------------------------------------------------------


def test_step_fault_invalidates_the_arena_and_recovers(pair):
    """An injected ``decode.step`` fault is replica health: every
    in-flight sequence fails loudly, the arena resets, and the next
    request generates the JAX engine's tokens."""
    _jeng, jentry, _arrays = pair
    teng, tentry = _port(pair, name="stepf")
    ref = jentry.offline_decode([5, 6], 4)
    victim = teng.submit([1, 2], max_new_tokens=8)
    tentry._iterate()
    assert tentry.stats()["active_slots"] == 1
    faults.configure([{"site": "decode.step", "action": "raise",
                       "times": 1}])
    try:
        tentry._iterate()
    finally:
        faults.reset()
    with pytest.raises(ReplicaLostError, match="decode-step failure"):
        victim.result(timeout=5)
    st = tentry.stats()
    assert st["step_failures"] == 1 and st["active_slots"] == 0
    assert all(not bool(tentry.scope.find_var(n).any())
               for kv in tentry.model.state_names for n in kv)
    out = teng.submit([5, 6], max_new_tokens=4)
    for _ in range(50):
        if out.done():
            break
        tentry._iterate()
    assert _tokens(out) == ref


def test_inject_failure_invalidates_arena_and_recovers(pair):
    """A failed inject fails the admitting request ("failed in inject")
    and every in-flight sequence ("arena failure"); the next request
    generates the JAX engine's tokens."""
    _jeng, jentry, _arrays = pair
    teng, tentry = _port(pair, name="injf")
    ref = jentry.offline_decode([5, 6], 4)
    victim = teng.submit([1, 2], max_new_tokens=8)
    tentry._iterate()
    faults.configure([{"site": "decode.inject", "action": "raise",
                       "times": 1}])
    try:
        doomed = teng.submit([3, 4], max_new_tokens=4)
        tentry._iterate()
    finally:
        faults.reset()
    with pytest.raises(RequestError, match="failed in inject"):
        doomed.result(timeout=5)
    with pytest.raises(RequestError, match="arena failure"):
        victim.result(timeout=5)
    out = teng.submit([5, 6], max_new_tokens=4)
    for _ in range(50):
        if out.done():
            break
        tentry._iterate()
    assert _tokens(out) == ref
    assert tentry.stats()["step_failures"] == 1
    assert teng.stats()["tenants"]["default"]["in_flight"] == 0


def test_breaker_opens_relaunches_once_and_serves_the_same_tokens(pair):
    """``breaker_threshold`` failed steps open the breaker; after the
    cooldown it half-opens and relaunches ONCE (zeroed arenas, the
    weights kept), the probe step closes it, and a request gives the
    tokens it gave before the fault."""
    _jeng, jentry, _arrays = pair
    teng, tentry = _port(pair, name="brk", breaker_threshold=3,
                         breaker_cooldown_s=0.05)
    prompt = [7, 3, 9]
    before = teng.submit(prompt, max_new_tokens=5)
    for _ in range(20):
        if before.done():
            break
        tentry._iterate()
    want = _tokens(before)
    assert want == jentry.offline_decode(prompt, 5)
    faults.configure([{"site": "decode.step", "action": "raise",
                       "times": 3}])
    try:
        for i in range(3):
            r = teng.submit([1 + i, 2], max_new_tokens=4)
            for _ in range(10):
                if r.done():
                    break
                tentry._iterate()
            with pytest.raises(ReplicaLostError):
                r.result(timeout=5)
    finally:
        faults.reset()
    st = tentry.stats()
    assert st["breaker_state"] == "open" and st["breaker_opened"] == 1
    assert st["step_failures"] == 3
    # while open, a queued request waits
    after = teng.submit(prompt, max_new_tokens=5)
    tentry._iterate()
    assert not after.done()
    time.sleep(0.06)
    for _ in range(20):
        if after.done():
            break
        tentry._iterate()
    assert _tokens(after) == want
    st = tentry.stats()
    assert st["relaunches"] == 1 and st["breaker_probes"] == 1
    assert st["breaker_state"] == "closed" and st["breaker_closed"] == 1


def test_half_open_breaker_relaunches_once_while_idle(pair):
    """An open breaker whose cooldown lapses with NO traffic does not
    rebuild the entry on every loop tick: one relaunch per half-open
    episode, then the probe STEP decides."""
    _jeng, jentry, _arrays = pair
    teng, tentry = _port(pair, name="idleprobe", breaker_threshold=1,
                         breaker_cooldown_s=0.05)
    faults.configure([{"site": "decode.step", "action": "raise",
                       "times": 1}])
    teng.start()
    try:
        with pytest.raises(RequestError):
            teng.submit([5, 6], max_new_tokens=4).result(timeout=120)
        time.sleep(0.6)  # many loop ticks past cooldown, zero traffic
        st = tentry.stats()
        assert st["relaunches"] == 1, st["relaunches"]
        assert st["breaker_probes"] == 1, st["breaker_probes"]
        out = teng.submit([5, 6], max_new_tokens=4).result(timeout=120)
        assert [int(t) for t in out["tokens"]] == jentry.offline_decode(
            [5, 6], 4)
    finally:
        teng.shutdown()
        faults.reset()
    assert tentry.stats()["breaker_state"] == "closed"


def test_relaunch_drops_the_tiers_block_writebacks_only(pair):
    """A relaunch zeroes the arenas, empties the pool and its radix, and
    drops the tier's ``blk:`` write-backs; parked sessions' ``park:``
    entries stay (they are host copies taken before the failure)."""
    teng, tentry = _port(pair, name="rel")
    rows = [(np.ones((2, 8), "float32"), np.ones((2, 8), "float32"))] * 2
    tentry._tier.put("blk:abc", rows, 2, tokens=(1, 2))
    tentry._tier.put("park:9:0", rows, 2, tokens=(1, 2))
    r = teng.submit([1, 2, 3], max_new_tokens=4)
    tentry._iterate()
    tentry.relaunch()
    assert "blk:abc" not in tentry._tier and "park:9:0" in tentry._tier
    assert tentry.block_pool.stats()["blocks_live"] == 0
    assert tentry.stats()["relaunches"] == 1
    assert not r.done()         # relaunch alone completes nothing


# ---------------------------------------------------------------------------
# metrics surface, options, lifecycle
# ---------------------------------------------------------------------------


def test_stats_hold_the_jax_engines_keys(pair):
    jeng, jentry, _arrays = pair
    teng, tentry = _port(pair, name="ten")
    out = teng.submit([2, 4, 6], tenant="acme", max_new_tokens=3)
    for _ in range(20):
        if out.done():
            break
        tentry._iterate()
    jeng.submit([2, 4, 6], tenant="acme", max_new_tokens=3).result(
        timeout=120)
    st, jst = tentry.stats(), jentry.stats()
    assert set(jst) - set(st) == NOT_IN_PORT
    assert set(st["host_tier"]) == set(jst["host_tier"])
    assert set(st["block_pool"]) == set(jst["block_pool"])
    assert set(st["brownout"]) == set(jst["brownout"])
    assert st["occupancy"] > 0.0
    assert 0.0 < st["tokens_per_step"] <= st["slots"]
    assert st["prefill_tokens"] == st["admitted"]
    for key in ("latency_p99_s", "queue_wait_p99_s", "decode_step_p99_s",
                "prefill_p99_s", "queue_drain_rate_rows_per_s",
                "queue_rejected_at_admission", "queue_expired_in_queue"):
        assert key in st, key
    assert st["latency_count"] == 1 and st["latency_p50_s"] > 0.0
    assert set(st["queue_lane_depths"]) == {"high", "normal", "low"}
    assert st["tenant_tokens"].get("acme", 0) >= 3
    assert set(teng.stats()) - {"place"} == set(jeng.stats())
    assert teng.stats()["tenants"]["acme"]["in_flight"] == 0
    text = obs_metrics.registry().to_text()
    assert "serving_tenant_tokens_total" in text
    assert "serving_queue_lane_depth" in text


def test_hbm_budget_raises_naming_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md, M12"):
        TorchEngine(place=pt.CPUPlace(), hbm_budget_mb=64)


def test_unregister_and_reroute_queued(pair):
    teng, tentry = _port(pair, name="life")
    teng.register_model(torch_build(**GEOM, name="life", version="2"))
    assert teng.entry("life").model.version == "2"
    queued = [teng.submit([1, 2], model="life", version="1",
                          tenant="t", max_new_tokens=2) for _ in range(3)]
    moved = teng.reroute_queued("life", "1")
    assert [r.response for r in moved] == queued
    assert tentry.stats()["queue_rerouted"] == 3
    assert teng.stats()["tenants"]["t"]["queued"] == 0
    teng.unregister_model("life", "2")
    assert teng.entry("life").model.version == "1"
    with pytest.raises(ValueError, match="no model"):
        teng.unregister_model("life", "2")
