"""The port's fleet over worker PROCESSES (``python -m
paddle_tpu_torch.serving.fleet.worker --device cpu``), at the JAX fleet
tests' tiny geometry:

* a worker killed mid-traffic by its ``replica.kill`` schedule exits
  with 43; the router re-dispatches its work, and every stream equals
  the JAX package's offline reference bit for bit (and the port's own);
  a scale-up worker then serves the same bits;
* a rolling deploy by worker replacement: a fresh worker hosting both
  versions takes the old worker's slot, the old version retires over
  the wire, and unversioned traffic moves to the new version's bytes,
  as the JAX engine gives them;
* a worker asked for the card where there is none exits before READY.

Each worker imports torch (seconds on the CPU), so a test runs at most
three, spawned side by side, and closes every one in a ``finally``.
"""

import json
import random
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.serving.decode import GenerationEngine as JaxEngine
from paddle_tpu.serving.decode import build_decoder_model as jax_build
from paddle_tpu_torch.serving.decode import GenerationEngine, build_decoder_model
from paddle_tpu_torch.serving.fleet import FleetRouter, SubprocessReplica
from paddle_tpu_torch.serving.fleet.replica import ReplicaError
from paddle_tpu_torch.serving.request import RejectedError

GEOM = dict(vocab_size=24, hidden=8, num_layers=1, slots=2, max_len=16)
TIMEOUT = 120


def _spawn(index, spec, extra_env=None):
    return SubprocessReplica.spawn(f"r{index}", index, spec,
                                   extra_env=extra_env, device="cpu",
                                   startup_timeout=TIMEOUT)


def _spawn_all(jobs):
    """Spawn workers side by side; close every one that came up if any
    spawn failed."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = [pool.submit(_spawn, *job) for job in jobs]
    handles, errors = [], []
    for f in futs:
        try:
            handles.append(f.result())
        except Exception as e:
            errors.append(e)
    if errors:
        for h in handles:
            h.kill()
            h.close(5)
        raise errors[0]
    return handles


def _references(name, prompts, max_new, **over):
    """(JAX offline, port offline) token lists for ``prompts``."""
    geom = {**GEOM, **over}
    jentry = JaxEngine(breaker_threshold=0).register_model(
        jax_build(name=name, version="1", **geom))
    tentry = GenerationEngine(place=pt.CPUPlace(),
                              breaker_threshold=0).register_model(
        build_decoder_model(name=name, version="1", **geom))
    return ([[int(t) for t in jentry.offline_decode(p, max_new)]
             for p in prompts],
            [[int(t) for t in tentry.offline_decode(p, max_new)]
             for p in prompts])


def test_killed_worker_exits_43_and_streams_stay_bit_equal():
    spec = {**GEOM, "name": "flt", "version": "1"}
    kill_sched = json.dumps([{
        "site": "replica.kill", "action": "kill", "at_call": 6,
        "rank": 1, "id": "sub-kill",
    }])
    rng = random.Random(1)
    prompts = [[rng.randrange(GEOM["vocab_size"])
                for _ in range(rng.randrange(1, 5))] for _ in range(10)]
    want, port_offline = _references("flt", prompts, 6)
    assert want == port_offline
    r0, r1 = _spawn_all([(0, spec), (1, spec,
                                     {"PADDLE_TPU_FAULTS": kill_sched})])
    assert r0.trace_count() == 0 and r1.ready_s > 0
    router = FleetRouter(replica_factory=lambda i: _spawn(i, spec),
                         health_interval_s=0.02)
    router.add_replica(r0)
    router.add_replica(r1)
    router.start()
    new = None
    try:
        resps = [router.submit(p, max_new_tokens=6) for p in prompts]
        outs = [[int(t) for t in r.result(timeout=TIMEOUT)["tokens"]]
                for r in resps]
        assert outs == want, "cross-process failover changed the bytes"
        assert r1.proc.wait(timeout=60) == 43
        st = router.stats()
        assert st["accepted"] == 10 and st["completed"] == 10
        assert st["replica_deaths"] == 1
        assert st["replicas"]["r1"]["state"] == "dead"
        new = router.scale_up()
        assert new.trace_count() == 0 and router.last_scaleup_s > 0
        r = router.submit(prompts[0], max_new_tokens=6)
        assert [int(t) for t in r.result(timeout=TIMEOUT)["tokens"]] \
            == want[0]
        ws = r0.worker_stats()
        assert ws["models"]["flt@1"]["completed"] >= 1
        assert set(ws["kernel_launches"]) >= {"paged_attention",
                                             "threefry_random_bits"}
    finally:
        router.shutdown()
    assert all(h.proc.poll() is not None for h in (r0, r1, new) if h)


def test_rolling_deploy_by_replacement_over_the_wire():
    spec = {**GEOM, "name": "flt_roll", "version": "1"}
    p = [3, 1, 4]
    (ref_v1,), _ = _references("flt_roll", [p], 4)
    (ref_v2,), (port_v2,) = _references("flt_roll", [p], 4, num_layers=2)
    assert ref_v1 != ref_v2 == port_v2
    (r0,) = _spawn_all([(0, spec)])
    old_pid = r0.proc.pid
    router = FleetRouter(health_interval_s=0.02)
    router.add_replica(r0)
    router.start()
    new = r0
    try:
        got = [int(t) for t in
               router.submit(p, max_new_tokens=4).result(TIMEOUT)["tokens"]]
        assert got == ref_v1
        router.deploy(None, version="2", name="flt_roll",
                      worker_spec={**GEOM, "num_layers": 2})
        new = router._replicas["r0"]
        assert isinstance(new, SubprocessReplica)
        assert new.proc.pid != old_pid, "no replacement worker spawned"
        assert r0.proc.poll() is not None, "old worker still running"
        assert new.models() == [("flt_roll", "2")]
        got = [int(t) for t in
               router.submit(p, max_new_tokens=4).result(TIMEOUT)["tokens"]]
        assert got == ref_v2, "unversioned traffic not on the new version"
        st = router.stats()
        assert st["replaced_deploys"] == 1 and st["deploys"] == 1
        assert st["pinned_versions"]["flt_roll"] == "2"
        with pytest.raises(RejectedError):
            router.submit(p, max_new_tokens=4, version="1")
    finally:
        router.shutdown()
    assert r0.proc.poll() is not None and new.proc.poll() is not None


def test_worker_on_the_card_without_one_exits_before_ready():
    """No silent fallback to the CPU: ``--device cuda`` (the default)
    without a card exits with 2 before the READY line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ReplicaError, match=r"exited during startup \(code 2\)"):
        SubprocessReplica.spawn("r0", 0, {**GEOM, "name": "nocard"},
                                startup_timeout=TIMEOUT)
