"""The port's fleet tier against the JAX package's, in process, at the JAX
fleet tests' tiny geometry on the CPU (vocab 24, hidden 8, 1 layer, 2
slots, max_len 16):

* both routers pick the same replica for the same prompts and replica
  ids — by rendezvous hash of the first KV block, spilled to the least
  loaded — and keep picking the same one as replicas leave and join;
* a fleet of the port's ``LocalReplica``s serves the JAX fleet's token
  streams bit for bit, and both equal the offline reference, with and
  without a replica killed mid-flight (each package's own
  ``replica.kill`` fault site);
* ``GenerationEngine.submit(deadline_at=)`` keeps the absolute deadline
  it is given, as the JAX engine does, and a re-dispatch keeps the
  original one;
* the rest of ``tests/test_fleet_serving.py``'s in-process cases on the
  port: health quarantine and re-admission, dispatch faults, shedding,
  scale-up/down, rolling deploys in place and by replacement, the
  error taxonomy.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu.serving.decode import GenerationEngine as JaxEngine
from paddle_tpu.serving.decode import build_decoder_model as jax_build
from paddle_tpu.serving.fleet import FleetRouter as JaxRouter
from paddle_tpu.serving.fleet import LocalReplica as JaxLocal
from paddle_tpu.serving.fleet.router import RoutedRequest as JaxRouted
from paddle_tpu.serving.request import DeadlineExceededError as JaxDeadline
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving.decode import GenerationEngine, build_decoder_model
from paddle_tpu_torch.serving.decode.engine import GenerationRequest
from paddle_tpu_torch.serving.decode.pool import block_hashes
from paddle_tpu_torch.serving.fleet import FleetRouter, LocalReplica
from paddle_tpu_torch.serving.fleet.replica import error_from_dict
from paddle_tpu_torch.serving.fleet.router import RoutedRequest
from paddle_tpu_torch.serving.queue import RequestQueue
from paddle_tpu_torch.utils.enforce import EnforceError
from paddle_tpu_torch.serving.request import (
    DeadlineExceededError,
    Priority,
    RejectedError,
    ReplicaLostError,
    RequestError,
)

GEOM = dict(vocab_size=24, hidden=8, num_layers=1, slots=2, max_len=16)
CPU = pt.CPUPlace()


def _builder(name="fleet_t", version="1", **over):
    kw = {**GEOM, **over}

    def b():
        return build_decoder_model(name=name, version=version, **kw)

    return b


def _jax_builder(name="fleet_t", version="1", **over):
    kw = {**GEOM, **over}

    def b():
        return jax_build(name=name, version=version, **kw)

    return b


def _local_factory(builder=None, queue_depth=64):
    b = builder or _builder()

    def factory(index):
        return LocalReplica.create(f"r{index}", index, b,
                                   queue_depth=queue_depth, place=CPU)

    return factory


def _jax_factory(builder=None, queue_depth=64):
    b = builder or _jax_builder()

    def factory(index):
        return JaxLocal.create(f"r{index}", index, b,
                               queue_depth=queue_depth)

    return factory


@pytest.fixture(autouse=True)
def clean_faults():
    """Both packages' injectors parse their schedules lazily ONCE: reset
    around every test so no schedule leaks."""
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


class _FakeHandle:
    """Routing-surface stub (load/index/models only) for the pure
    routing-policy tests, usable under either package's router."""

    transport = "fake"

    def __init__(self, rid, index, load=0):
        self.rid = rid
        self.index = index
        self._load = load

    def load(self):
        return self._load

    def models(self):
        return [("m", "1")]

    def trace_count(self):
        return 0

    def close(self, timeout=0):
        pass


def _route_of(router, prompt, routed=RoutedRequest):
    rr = routed(0, prompt, 4, "t", Priority.NORMAL, None, "m", "1")
    with router._lock:
        return router._route(rr, set())


def _drop(router, rid):
    with router._lock:
        del router._replicas[rid]
        del router._health[rid]


def _prompts(n, seed, lo=1, hi=9, vocab=GEOM["vocab_size"]):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _tokens(resp, timeout=120):
    return [int(t) for t in resp.result(timeout=timeout)["tokens"]]


# ---------------------------------------------------------------------------
# routing policy against the JAX router
# ---------------------------------------------------------------------------


def test_routes_match_the_jax_router_under_membership_change():
    prompts = _prompts(64, seed=5, hi=12)
    port = FleetRouter(affinity_prefix=4)
    ref = JaxRouter(affinity_prefix=4)
    for i in range(5):
        port.add_replica(_FakeHandle(f"r{i}", i))
        ref.add_replica(_FakeHandle(f"r{i}", i))

    def routes():
        got = [_route_of(port, p) for p in prompts]
        want = [_route_of(ref, p, JaxRouted) for p in prompts]
        assert got == want
        return got

    before = routes()
    assert len(set(before)) > 1
    for router in (port, ref):      # a replica leaves
        _drop(router, "r2")
    after = routes()
    # rendezvous: only the keys the departed replica owned move
    assert all(a == b for a, b in zip(before, after) if a != "r2")
    for router in (port, ref):      # a replica joins
        router.add_replica(_FakeHandle("r9", 9))
    routes()
    for router in (port, ref):      # a dead one and a draining one
        with router._lock:
            router._health["r0"].mark_dead("test")
            router._draining.add("r1")
    routes()


def test_spill_routes_match_the_jax_router_when_saturated():
    prompts = _prompts(32, seed=7)
    loads = {"r0": 10, "r1": 0, "r2": 10, "r3": 4}
    port = FleetRouter(affinity_prefix=4, saturation_rows=5)
    ref = JaxRouter(affinity_prefix=4, saturation_rows=5)
    for i, (rid, load) in enumerate(sorted(loads.items())):
        port.add_replica(_FakeHandle(rid, i, load=load))
        ref.add_replica(_FakeHandle(rid, i, load=load))
    got = [_route_of(port, p) for p in prompts]
    assert got == [_route_of(ref, p, JaxRouted) for p in prompts]
    assert set(got) <= {"r1", "r3"}    # saturated targets spilled


def test_rendezvous_affinity_stable_under_membership_change():
    router = FleetRouter(affinity_prefix=4)
    for i in range(3):
        router.add_replica(_FakeHandle(f"r{i}", i))
    prompt = [3, 1, 4, 1, 5]
    target = _route_of(router, prompt)
    assert _route_of(router, prompt) == target
    assert _route_of(router, prompt[:4] + [9]) == target
    other = next(r for r in router._replicas if r != target)
    _drop(router, other)
    assert _route_of(router, prompt) == target
    _drop(router, target)
    moved = _route_of(router, prompt)
    assert moved is not None and moved != target


def test_affinity_key_is_block_hash_chain():
    router = FleetRouter(affinity_prefix=4)
    for i in range(4):
        router.add_replica(_FakeHandle(f"r{i}", i))
    first_block = [9, 2, 7, 4]
    targets = {_route_of(router, first_block + list(tail))
               for tail in ([], [1], [3, 3, 3], list(range(8)))}
    assert len(targets) == 1, targets
    assert (block_hashes(first_block + [1, 2], 4)[0]
            == block_hashes(first_block + [8], 4)[0])
    assert _route_of(router, [1, 2]) == _route_of(router, [1, 2])


def test_dead_and_draining_replicas_leave_the_routing_set():
    router = FleetRouter()
    for i in range(2):
        router.add_replica(_FakeHandle(f"r{i}", i))
    with router._lock:
        router._health["r0"].mark_dead("test")
        router._draining.add("r1")
        assert router._routable() == []
    with router._lock:
        router._draining.discard("r1")
        assert router._routable() == ["r1"]


# ---------------------------------------------------------------------------
# token streams against the JAX fleet
# ---------------------------------------------------------------------------


def _serve(router, prompts, max_new, kill_rank, faults_mod, armed_at=1):
    """Submit ``prompts`` one by one; with ``kill_rank``, arm the
    package's ``replica.kill`` schedule once that replica holds live
    work (or at the last submit)."""
    resps = []
    armed = kill_rank is None
    victim = f"r{kill_rank}"
    for i, p in enumerate(prompts):
        resps.append(router.submit(p, max_new_tokens=max_new))
        if not armed:
            with router._lock:
                holding = sum(1 for rr in router._inflight.values()
                              if rr.replica == victim
                              and rr.state == "inflight")
            if holding >= armed_at or i == len(prompts) - 1:
                faults_mod.configure([{"site": "replica.kill",
                                       "action": "raise",
                                       "rank": kill_rank}])
                armed = True
        time.sleep(0.002)
    return [_tokens(r) for r in resps]


def _wait_dead(router, rid, timeout=30.0):
    deadline = time.monotonic() + timeout
    while (router.replicas()[rid] != "dead"
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert router.replicas()[rid] == "dead"


def _pause(entry):
    """Hold ``entry``'s scheduler between iterations (no lock held, so
    the router's heartbeats and load reads go on); returns the gate to
    set."""
    gate = threading.Event()
    step = entry._iterate

    def gated():
        gate.wait()
        return step()

    entry._iterate = gated
    time.sleep(0.05)    # the loop finishes the iteration it is in
    return gate


@pytest.mark.parametrize("kill", [False, True], ids=["steady", "kill"])
def test_streams_match_the_jax_fleet_bit_for_bit(kill):
    """The same prompts through a port fleet and a JAX fleet of 3 local
    replicas each: the same token streams, bit for bit, both equal to the
    offline reference; with ``kill``, replica r1 dies mid-flight in both
    fleets and its work re-dispatches."""
    prompts = _prompts(12, seed=3, hi=5)
    max_new = 6
    port = FleetRouter(health_interval_s=0.01)
    ref = JaxRouter(health_interval_s=0.01)
    pf, jf = _local_factory(), _jax_factory()
    for i in range(3):
        port.add_replica(pf(i))
        ref.add_replica(jf(i))
    port.start()
    ref.start()
    try:
        entry = port._replicas["r0"].engine.entry("fleet_t", "1")
        offline = [entry.offline_decode(p, max_new) for p in prompts]
        kill_rank = 1 if kill else None
        got = _serve(port, prompts, max_new, kill_rank, faults)
        want = _serve(ref, prompts, max_new, kill_rank, jax_faults)
        assert got == want == offline
        for router in (port, ref):
            if kill:    # the kill lands at the victim's next heartbeat
                _wait_dead(router, "r1")
            st = router.stats()
            assert st["accepted"] == st["completed"] == len(prompts)
            assert st["replica_deaths"] == (1 if kill else 0)
            if kill:
                assert st["replicas"]["r1"]["state"] == "dead"
    finally:
        faults.reset()
        jax_faults.reset()
        port.shutdown()
        ref.shutdown()


def test_kill_mid_flight_redispatches_bit_identical():
    """THE failover property: a replica dies while holding live work;
    every accepted request still completes, byte-identical to the
    offline reference, and the re-dispatches are counted."""
    router = FleetRouter(health_interval_s=0.01)
    factory = _local_factory()
    for i in range(3):
        router.add_replica(factory(i))
    router.start()
    try:
        rng = random.Random(3)
        prompts = [[rng.randrange(GEOM["vocab_size"])
                    for _ in range(rng.randrange(1, 5))] for _ in range(12)]
        entry = router._replicas["r0"].engine.entry("fleet_t", "1")
        refs = [entry.offline_decode(p, 6) for p in prompts]
        # the victim dies at its next heartbeat once it holds work; its
        # scheduler is held meanwhile, so the work is still in flight
        # there when the kill lands, however fast the survivors decode
        gate = _pause(router._replicas["r1"].engine.entry("fleet_t", "1"))
        try:
            resps = [router.submit(p, max_new_tokens=6) for p in prompts]
            with router._lock:
                holding = sum(1 for rr in router._inflight.values()
                              if rr.replica == "r1")
            assert holding >= 1
            faults.configure([{"site": "replica.kill", "action": "raise",
                               "rank": 1}])
            _wait_dead(router, "r1")
        finally:
            gate.set()
        outs = [_tokens(r) for r in resps]
        assert outs == refs, "failover changed the bytes"
        st = router.stats()
        assert st["accepted"] == 12 and st["completed"] == 12
        assert st["replica_deaths"] == 1
        assert st["replicas"]["r1"]["state"] == "dead"
        assert st["rerouted"] >= 1
    finally:
        router.shutdown()


def test_fleet_serves_bit_identical_to_offline_reference():
    router = FleetRouter(health_interval_s=0.05)
    factory = _local_factory()
    for i in range(2):
        router.add_replica(factory(i))
    router.start()
    try:
        prompts = [[3, 1, 4], [1, 5], [3, 1, 4], [9, 2, 6, 5]]
        entry = router._replicas["r0"].engine.entry("fleet_t", "1")
        refs = [entry.offline_decode(p, 5) for p in prompts]
        resps = [router.submit(p, max_new_tokens=5) for p in prompts]
        assert [_tokens(r) for r in resps] == refs
        st = router.stats()
        assert st["accepted"] == 4 and st["completed"] == 4
        assert st["failed"] == 0 and st["replica_deaths"] == 0
    finally:
        router.shutdown()


def test_injected_dispatch_fault_fails_over_invisibly():
    router = FleetRouter(health_interval_s=0.05)
    factory = _local_factory()
    for i in range(2):
        router.add_replica(factory(i))
    router.start()
    try:
        faults.configure([{"site": "fleet.dispatch", "action": "raise",
                           "rank": 0, "times": 1, "id": "d0"}])
        for k in range(6):
            r = router.submit([k + 1, 2, 3], max_new_tokens=3)
            assert len(_tokens(r)) == 3
        assert faults.get_injector().rule_stats()["d0"]["fired"] == 1
        st = router.stats()
        assert st["dispatch_faults"] == 1
        assert st["accepted"] == 6 and st["completed"] == 6
        assert st["replicas"]["r0"]["state"] in ("closed", "half_open")
    finally:
        router.shutdown()


def test_health_fault_quarantines_then_readmits():
    router = FleetRouter(health_interval_s=0.01, breaker_threshold=2,
                         breaker_cooldown_s=0.03)
    factory = _local_factory()
    for i in range(2):
        router.add_replica(factory(i))
    router.start()
    try:
        faults.configure([{"site": "fleet.health", "action": "raise",
                           "rank": 0, "times": 2, "id": "h0"}])
        deadline = time.monotonic() + 10
        while (router.metrics.count("breaker_opened") < 1
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert router.metrics.count("breaker_opened") >= 1
        deadline = time.monotonic() + 10
        while (router.replicas()["r0"] != "closed"
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert router.replicas()["r0"] == "closed"
        assert router.metrics.count("breaker_closed") >= 1
        r = router.submit([1, 2], max_new_tokens=3)
        assert len(_tokens(r)) == 3
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# deadlines: submit(deadline_at=) and re-dispatch (hand-stepped)
# ---------------------------------------------------------------------------


def test_engine_submit_deadline_at_matches_the_jax_engine():
    """An absolute ``perf_counter`` deadline wins over ``deadline_ms`` in
    both engines and reaches the queued request as given; one already
    past completes with DeadlineExceededError in both."""
    port = GenerationEngine(place=CPU, queue_depth=8, breaker_threshold=0)
    pentry = port.register_model(_builder(name="dl"))
    ref = JaxEngine(queue_depth=8, breaker_threshold=0)
    jentry = ref.register_model(_jax_builder(name="dl"))
    at = time.perf_counter() + 30.0
    for eng, entry in ((port, pentry), (ref, jentry)):
        eng.submit([1, 2, 3], max_new_tokens=2, deadline_at=at,
                   deadline_ms=1.0)
        assert entry._queue.iter_requests()[-1].deadline == at
        eng.submit([1, 2, 3], max_new_tokens=2, deadline_ms=60000.0)
        assert entry._queue.iter_requests()[-1].deadline < at + 31.0
    late = [eng.submit([4, 5], max_new_tokens=2, deadline_at=1.0)
            for eng in (port, ref)]
    port.start()
    ref.start()
    try:
        with pytest.raises(DeadlineExceededError):
            late[0].result(timeout=60)
        with pytest.raises(JaxDeadline):
            late[1].result(timeout=60)
    finally:
        port.shutdown()
        ref.shutdown()


def _unstarted_local(rid, index, builder):
    """A LocalReplica whose engine scheduler is NOT running: submissions
    sit in the queue, so dispatch state is fully deterministic."""
    engine = GenerationEngine(place=CPU, queue_depth=64, breaker_threshold=0,
                              label=f"fleet-hand-{rid}")
    engine.register_model(builder)
    return LocalReplica(rid, index, engine)


def test_redispatch_preserves_original_deadline():
    router = FleetRouter(health_interval_s=1e9)  # hand-stepped: no pump
    b = _builder()
    for i in range(2):
        router.add_replica(_unstarted_local(f"r{i}", i, b))
    resp = router.submit([1, 2, 3], max_new_tokens=4, deadline_ms=60000)
    (rr,) = router._inflight.values()
    victim = rr.replica
    original = rr.deadline_at
    assert original is not None
    inner_q = router._replicas[victim].engine.entry("fleet_t", "1")._queue
    assert inner_q.iter_requests()[0].deadline == original
    router._replicas[victim].kill()
    router._mark_dead(victim, "test")
    assert rr.state == "parked"
    router._tick()
    assert rr.state == "inflight" and rr.replica != victim
    assert rr.deadline_at == original, "re-dispatch refreshed the budget"
    survivor_q = router._replicas[rr.replica].engine.entry(
        "fleet_t", "1")._queue
    assert survivor_q.iter_requests()[0].deadline == original
    assert not resp.done()


def test_expired_budget_completes_deadline_not_lost():
    router = FleetRouter(health_interval_s=1e9)
    b = _builder()
    for i in range(2):
        router.add_replica(_unstarted_local(f"r{i}", i, b))
    resp = router.submit([1, 2], max_new_tokens=4, deadline_ms=5)
    (rr,) = router._inflight.values()
    router._replicas[rr.replica].kill()
    router._mark_dead(rr.replica, "test")
    time.sleep(0.01)  # past the 5ms budget
    router._tick()
    assert resp.done()
    with pytest.raises(DeadlineExceededError):
        resp.result()
    assert router.metrics.count("deadline_missed") == 1
    assert router.metrics.count("rerouted") == 0


def test_parked_request_for_retired_version_completes_structured():
    router = FleetRouter(health_interval_s=1e9)
    b = _builder(name="dd", version="1")
    for i in range(2):
        router.add_replica(_unstarted_local(f"r{i}", i, b))
    resp = router.submit([1, 2], max_new_tokens=3)
    (rr,) = router._inflight.values()
    victim = rr.replica
    router._replicas[victim].kill()
    router._mark_dead(victim, "test")
    survivor = next(r for r in router._replicas if r != victim)
    router._replicas[survivor].engine.unregister_model("dd", "1")
    router._tick()
    assert resp.done()
    with pytest.raises(RejectedError):
        resp.result()
    assert rr.id not in router._inflight


def test_queue_reroute_counts_apart_from_rejections():
    q = RequestQueue(max_depth=3)
    reqs = [GenerationRequest(i, [1], 2, "t", Priority.NORMAL, None)
            for i in range(3)]
    for r in reqs:
        q.put(r)
    with pytest.raises(RejectedError):
        q.put(GenerationRequest(9, [1], 2, "t", Priority.NORMAL, None))
    q.reroute(reqs[:2])
    st = q.stats()
    assert st["rerouted"] == 2
    assert st["rejected_at_admission"] == 1
    assert st["expired_in_queue"] == 0
    assert st["depth"] == 1


def test_engine_reroute_queued_and_unregister():
    engine = GenerationEngine(place=CPU, queue_depth=64, breaker_threshold=0,
                              label="fleet-reroute-unit")
    engine.register_model(_builder(name="ru", version="1"))
    for k in range(3):
        engine.submit([k + 1, 2], max_new_tokens=3, tenant="a")
    stolen = engine.reroute_queued("ru", "1")
    assert len(stolen) == 3
    entry = engine.entry("ru", "1")
    assert entry._queue.depth() == 0
    assert entry._queue.stats()["rerouted"] == 3
    assert engine.stats()["tenants"]["a"]["queued"] == 0
    engine.register_model(_builder(name="ru", version="2"))
    assert engine.entry("ru").model.version == "2"
    engine.unregister_model("ru", "2")
    assert engine.entry("ru").model.version == "1"
    engine.unregister_model("ru", "1")
    with pytest.raises(RejectedError):
        engine.entry("ru")


def test_entry_notify_and_prefix_cache():
    engine = GenerationEngine(place=CPU, queue_depth=8, breaker_threshold=0)
    entry = engine.register_model(_builder(name="nc"))
    assert entry.prefix_cache is entry._prefix
    entry.notify()    # wakes a waiting scheduler; a no-op without one


# ---------------------------------------------------------------------------
# shedding, elasticity, rolling deploys
# ---------------------------------------------------------------------------


def test_fleet_sheds_with_measured_retry_after_when_saturated():
    router = FleetRouter(health_interval_s=1e9)
    b = _builder()
    for i in range(2):
        h = LocalReplica(f"r{i}", i, GenerationEngine(
            place=CPU, queue_depth=1, breaker_threshold=0,
            label=f"fleet-shed-{i}"))
        h.engine.register_model(b)
        router.add_replica(h)
    accepted = 0
    shed = None
    for k in range(4):
        try:
            router.submit([k + 1, 2], max_new_tokens=3)
            accepted += 1
        except RejectedError as e:
            shed = e
    assert accepted == 2
    assert shed is not None and shed.retry_after_s > 0
    assert router.metrics.count("rejected_shed") == 2
    assert router.metrics.count("accepted") == 2


def test_scale_up_and_scale_down_drains():
    factory = _local_factory()
    router = FleetRouter(replica_factory=factory, health_interval_s=0.05)
    for i in range(2):
        router.add_replica(factory(i))
    router.start()
    try:
        new = router.scale_up()
        assert new.trace_count() == 0   # the eager port traces nothing
        assert router.last_scaleup_traces == 0
        assert router.last_scaleup_s > 0
        assert len(router.replicas()) == 3
        router.submit([1, 2, 3], max_new_tokens=3).result(timeout=120)
        assert router.scale_down() is not None
        assert len(router.replicas()) == 2
        st = router.stats()
        assert st["scale_ups"] == 1 and st["scale_downs"] == 1
    finally:
        router.shutdown()


def test_rolling_deploy_pins_until_complete_then_flips():
    router = FleetRouter(health_interval_s=0.05)
    factory = _local_factory()
    for i in range(2):
        router.add_replica(factory(i))
    router.start()
    try:
        p = [3, 1, 4]
        ref_v1 = router._replicas["r0"].engine.entry(
            "fleet_t", "1").offline_decode(p, 4)
        stop = False
        mid_roll = []

        def traffic():
            while not stop:
                try:
                    r = router.submit(p, max_new_tokens=4)
                    mid_roll.append(_tokens(r, 60))
                except Exception as e:  # any error mid-roll is a finding
                    mid_roll.append(("ERR", str(e)))
                time.sleep(0.004)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        router.deploy(_builder(name="fleet_t", version="2", num_layers=2),
                      version="2")
        stop = True
        t.join(30)
        ref_v2 = router._replicas["r0"].engine.entry(
            "fleet_t", "2").offline_decode(p, 4)
        assert ref_v2 != ref_v1
        bad = [x for x in mid_roll
               if not (isinstance(x, list) and x in (ref_v1, ref_v2))]
        assert not bad, f"mid-roll traffic disturbed: {bad[:3]}"
        switches = [a != b for a, b in zip(mid_roll, mid_roll[1:])]
        assert sum(switches) <= 1, "mid-roll traffic flapped versions"
        assert mid_roll and mid_roll[0] == ref_v1
        assert _tokens(router.submit(p, max_new_tokens=4), 60) == ref_v2
        for rid in ("r0", "r1"):
            assert router._replicas[rid].models() == [("fleet_t", "2")]
        st = router.stats()
        assert st["pinned_versions"] == {"fleet_t": "2"}
        assert st["deploys"] == 1
        with pytest.raises(RejectedError):
            router.submit(p, max_new_tokens=4, version="1")
    finally:
        router.shutdown()


class _FakeReplaceableHandle(_FakeHandle):
    """A subprocess-shaped handle: deploys by replacement, retires over
    the 'wire'. Records the protocol calls the router makes."""

    transport = "fake-subprocess"

    def __init__(self, rid, index, hosted=None, log=None):
        super().__init__(rid, index)
        self.hosted = hosted or [("m", "1")]
        self.log = log if log is not None else []
        self.closed = False

    def models(self):
        return list(self.hosted)

    def deploy(self, builder, name, new_version):
        raise AssertionError("in-place deploy on a replacement handle")

    def spawn_replacement(self, new_spec, startup_timeout=0):
        self.log.append(("spawn_replacement", self.rid, new_spec["name"],
                         new_spec["version"]))
        return _FakeReplaceableHandle(
            self.rid, self.index,
            hosted=self.hosted + [(new_spec["name"],
                                   str(new_spec["version"]))],
            log=self.log)

    def steal_queued(self):
        self.log.append(("steal", self.rid))
        return []

    def retire(self, name, version, timeout=0):
        self.log.append(("retire", self.rid, name, str(version)))
        self.hosted = [m for m in self.hosted if m != (name, str(version))]

    def close(self, timeout=0):
        self.log.append(("close", self.rid))
        self.closed = True


def test_deploy_by_replacement_protocol_order():
    router = FleetRouter(health_interval_s=1e9)
    log = []
    old = _FakeReplaceableHandle("r0", 0, log=log)
    router.add_replica(old)

    class _LocalFake(_FakeHandle):
        deploys = []

        def deploy(self, builder, name, version):
            self.deploys.append((name, version))

    local = _LocalFake("r1", 1)
    router.add_replica(local)
    with pytest.raises(RuntimeError, match="worker_spec"):
        router.deploy(None, version="2", name="m")
    assert not old.closed and router._replicas["r0"] is old
    assert not log and not local.deploys
    _drop(router, "r1")
    router.deploy(None, version="2", name="m", worker_spec={"hidden": 8})
    new = router._replicas["r0"]
    assert new is not old and old.closed and not new.closed
    assert new.models() == [("m", "2")]
    assert router.stats()["pinned_versions"]["m"] == "2"
    assert router.metrics.count("replaced_deploys") == 1
    assert router.metrics.count("deploys") == 1
    spawn_i = log.index(("spawn_replacement", "r0", "m", "2"))
    steal_i = log.index(("steal", "r0"))
    close_i = log.index(("close", "r0"))
    retire_i = log.index(("retire", "r0", "m", "1"))
    assert spawn_i < steal_i < close_i < retire_i


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------


def test_router_rejects_invalid_submissions_structured():
    router = FleetRouter(health_interval_s=1e9)
    router.add_replica(_FakeHandle("r0", 0))
    for bad_call in (
        lambda: router.submit([], max_new_tokens=3),
        lambda: router.submit("nope", max_new_tokens=3),
        lambda: router.submit([1, 2], max_new_tokens=0),
    ):
        with pytest.raises(RejectedError):
            bad_call()
    assert router.metrics.count("rejected_invalid") == 3
    assert router.metrics.count("accepted") == 0


def test_replica_lost_error_classifies_for_failover():
    assert issubclass(ReplicaLostError, RequestError)
    assert ReplicaLostError("x").code == "replica_lost"
    e = error_from_dict(ReplicaLostError("lost mid-step").to_dict())
    assert isinstance(e, ReplicaLostError)
    e = error_from_dict(RejectedError("full", retry_after_s=0.5).to_dict())
    assert isinstance(e, RejectedError) and e.retry_after_s == 0.5


def test_local_replica_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default place is reachable")
    with pytest.raises(EnforceError, match="CPUPlace"):
        LocalReplica.create("r0", 0, _builder())


def test_torch_chaos_serve_smoke_cli():
    """The chaos harness end to end through its CLI on the CPU: kill one
    of three replicas mid-flight, zero loss, bit-identity, re-dispatches
    counted, a replacement serving-ready within its bound, bounded p99;
    and the overload leg's kill of a replica holding parked sessions."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "torch_chaos_serve.py"),
         "--smoke", "--json", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    payload = json.loads(
        [ln for ln in res.stdout.splitlines() if ln.startswith("{")][-1])
    assert payload["pass"] and payload["failures"] == []
    assert payload["invariants"]["lost"] == 0
    assert payload["invariants"]["bit_identical"] is True
    assert payload["measured"]["rerouted"] >= 1
    assert (payload["measured"]["scaleup_ready_s"]
            <= payload["measured"]["scaleup_ready_bound_s"])
    assert payload["overload"]["invariants"]["lost"] == 0
