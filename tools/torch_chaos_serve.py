#!/usr/bin/env python3
"""Chaos harness for the port's fleet router: kill a replica mid-flight
and prove nothing was lost.

The port of ``tools/chaos_serve.py`` on ``paddle_tpu_torch``'s fleet. An
open-loop request stream runs against a FleetRouter over N in-process
decode replicas on ``--device`` (``cuda``, the default, or ``cpu``);
once the designated victim replica holds live work, a ``replica.kill``
fault schedule is armed and the victim dies at its next heartbeat. The
router must

(a) re-dispatch every request the dead replica held — ZERO
    accepted-then-lost;
(b) deliver every generation BIT-IDENTICAL to the single-replica offline
    reference (decode is deterministic, so failover is invisible in the
    bytes);
(c) replace the victim via autoscale with a replica that is serving-ready
    within ``SCALEUP_READY_BOUND_S`` (the eager port compiles nothing, so
    where the JAX harness gates on zero XLA traces this one gates on the
    replacement's seconds to serving-ready, and prints them);
(d) keep the p99 degradation against the no-chaos baseline leg bounded.

``--smoke`` runs the seconds-scale configuration, and the overload leg
(a replica killed WHILE it holds parked sessions), and asserts all of
it; ``--json`` prints one JSON object. It writes no evidence file.

Usage:
  python tools/torch_chaos_serve.py [--device cuda|cpu] [--replicas 3]
      [--requests 18] [--kill-replica 1] [--seed 2] [--smoke]
      [--overload] [--json]
"""

import argparse
import hashlib
import json
import logging
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# p99 gate: generous (host timing on a shared machine is noisy) but
# BOUNDED — chaos must not turn tail latency into an outage
P99_RATIO_BOUND = 15.0
P99_FLOOR_S = 2.0
# the autoscale replacement's seconds from the factory call to a
# serving-ready replica (its startup program, on the device)
SCALEUP_READY_BOUND_S = 120.0


def _p99(samples):
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(int(len(s) * 0.99), len(s) - 1)]


def _place(cfg):
    import paddle_tpu_torch as fluid

    return (fluid.CUDAPlace(0) if cfg["device"] == "cuda"
            else fluid.CPUPlace())


def make_builder(cfg, version="1"):
    def builder():
        from paddle_tpu_torch.serving.decode import build_decoder_model

        extra = {k: cfg[k] for k in ("block_size", "num_blocks")
                 if k in cfg}
        return build_decoder_model(
            vocab_size=cfg["vocab_size"], hidden=cfg["hidden"],
            num_layers=cfg["num_layers"], slots=cfg["slots"],
            max_len=cfg["max_len"], name=cfg["model_name"],
            version=version, **extra,
        )
    return builder


def make_workload(cfg):
    """The deterministic open-loop request set: seeded prompts (with
    repeats, so prefix affinity has something to dedup) + fixed
    max_new."""
    rng = random.Random(cfg["seed"])
    prompts = []
    for i in range(cfg["requests"]):
        if i > 0 and rng.random() < 0.35:
            prompts.append(list(rng.choice(prompts)))  # repeat: prefix hit
        else:
            prompts.append([rng.randrange(cfg["vocab_size"])
                            for _ in range(rng.randrange(1, 5))])
    return prompts


def offline_references(cfg, prompts):
    """Single-replica offline reference per unique prompt — THE bytes
    every fleet-served generation must match, however many replicas or
    failovers were involved."""
    from paddle_tpu_torch.serving.decode import GenerationEngine

    engine = GenerationEngine(place=_place(cfg), breaker_threshold=0,
                              label="chaos-ref")
    entry = engine.register_model(make_builder(cfg))
    refs = {}
    for p in prompts:
        key = tuple(p)
        if key not in refs:
            refs[key] = [int(t) for t in
                         entry.offline_decode(p, cfg["max_new"])]
    return refs


def _factory(cfg, builder, queue_depth):
    from paddle_tpu_torch.serving.fleet import LocalReplica

    def factory(index):
        return LocalReplica.create(f"r{index}", index, builder,
                                   queue_depth=queue_depth,
                                   place=_place(cfg))

    return factory


def run_leg(cfg, prompts, kill=False):
    """One open-loop leg through a fresh router. With ``kill``, the
    victim replica dies (via the ``replica.kill`` fault site) at its
    first heartbeat after it is observed holding live work, and
    autoscale must replace it."""
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving.fleet import FleetRouter

    factory = _factory(cfg, make_builder(cfg), cfg["requests"] * 2 + 8)
    router = FleetRouter(
        replica_factory=factory, health_interval_s=0.02,
        min_replicas=cfg["replicas"], max_replicas=cfg["replicas"] + 1,
        autoscale=kill, breaker_threshold=3,
        label=f"chaos-{'kill' if kill else 'base'}-{cfg['seed']}",
    )
    for i in range(cfg["replicas"]):
        router.add_replica(factory(i))
    router.start()
    victim = f"r{cfg['kill_replica']}"
    armed = False
    responses = []
    submit_t = []
    try:
        for i, p in enumerate(prompts):
            responses.append(router.submit(p, max_new_tokens=cfg["max_new"]))
            submit_t.append(time.perf_counter())
            if kill and not armed:
                with router._lock:
                    holding = sum(
                        1 for rr in router._inflight.values()
                        if rr.replica == victim and rr.state == "inflight")
                # arm once the victim holds live work (mid-flight kill);
                # fall back to arming on the last submit so the kill
                # always fires even under a pathological affinity split
                if holding >= 2 or i == len(prompts) - 1:
                    faults.configure([{
                        "site": "replica.kill", "action": "raise",
                        "rank": cfg["kill_replica"], "id": "chaos-kill",
                    }])
                    armed = True
            time.sleep(cfg["arrival_s"])
        outs = []
        lat = []
        for r, t0 in zip(responses, submit_t):
            res = r.result(timeout=240)
            outs.append([int(t) for t in res["tokens"]])
            lat.append(r.finish_time - t0)
        if kill:
            # the dead replica's autoscale replacement must arrive
            deadline = time.monotonic() + SCALEUP_READY_BOUND_S
            while time.monotonic() < deadline:
                if router.metrics.count("scale_ups") >= 1:
                    break
                time.sleep(0.02)
        stats = router.stats()
        fired = {}
        inj = faults.get_injector()
        if inj is not None:
            fired = {k: v["fired"] for k, v in inj.rule_stats().items()}
        return {"outs": outs, "latencies": lat, "stats": stats,
                "rule_fired": fired,
                "scaleup_s": router.last_scaleup_s}
    finally:
        faults.reset()
        router.shutdown()


def run_scenario(cfg):
    """Both legs + the invariant checks; returns the full report."""
    prompts = make_workload(cfg)
    refs = offline_references(cfg, prompts)

    base = run_leg(cfg, prompts, kill=False)
    chaos = run_leg(cfg, prompts, kill=True)

    failures = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)
        return ok

    for leg_name, leg in (("baseline", base), ("chaos", chaos)):
        st = leg["stats"]
        check(st["accepted"] == cfg["requests"],
              f"{leg_name}: accepted {st['accepted']} != {cfg['requests']}")
        check(st["completed"] == st["accepted"],
              f"{leg_name}: ZERO-LOSS VIOLATED — accepted "
              f"{st['accepted']} but completed {st['completed']} "
              f"(failed={st['failed']} deadline={st['deadline_missed']} "
              f"drained={st['drained_unserved']})")
        bad = [i for i, (p, o) in enumerate(zip(prompts, leg["outs"]))
               if o != refs[tuple(p)]]
        check(not bad,
              f"{leg_name}: BIT-IDENTITY VIOLATED on requests {bad[:5]}")

    cst = chaos["stats"]
    check(chaos["rule_fired"].get("chaos-kill", 0) == 1,
          "the replica.kill fault never fired")
    check(cst["replica_deaths"] == 1,
          f"expected exactly 1 replica death, saw {cst['replica_deaths']}")
    check(cst["rerouted"] >= 1,
          f"kill landed with nothing to re-dispatch (rerouted="
          f"{cst['rerouted']}) — not a mid-flight kill")
    check(cst["scale_ups"] >= 1, "autoscale never replaced the victim")
    scaleup_s = chaos["scaleup_s"]
    check(scaleup_s is not None and scaleup_s <= SCALEUP_READY_BOUND_S,
          f"the replacement took {scaleup_s}s to serving-ready (bound "
          f"{SCALEUP_READY_BOUND_S}s)")

    p99_base = _p99(base["latencies"])
    p99_chaos = _p99(chaos["latencies"])
    bound = max(P99_RATIO_BOUND * p99_base, P99_FLOOR_S)
    check(p99_chaos <= bound,
          f"p99 under chaos {p99_chaos:.3f}s exceeds bound {bound:.3f}s "
          f"(baseline {p99_base:.3f}s)")

    digest = hashlib.sha256(json.dumps(
        [[i, out] for i, out in enumerate(chaos["outs"])]
    ).encode()).hexdigest()

    return {
        "scenario": {k: cfg[k] for k in sorted(cfg)},
        "invariants": {
            "accepted": cst["accepted"],
            "completed": cst["completed"],
            "lost": cst["accepted"] - cst["completed"],
            "bit_identical": not any("BIT-IDENTITY" in f
                                     for f in failures),
            "kill_fired": chaos["rule_fired"].get("chaos-kill", 0) == 1,
            "replica_deaths": cst["replica_deaths"],
            "unique_prompts": len(refs),
            "tokens_digest": digest,
        },
        "measured": {
            "rerouted": cst["rerouted"],
            "stolen_queued": cst["stolen_queued"],
            "breaker_probes": cst["breaker_probes"],
            "scaleup_ready_s": scaleup_s,
            "scaleup_ready_bound_s": SCALEUP_READY_BOUND_S,
            "p99_base_ms": p99_base * 1e3,
            "p99_chaos_ms": p99_chaos * 1e3,
            "p99_bound_ms": bound * 1e3,
            "replica_states": {rid: r["state"] for rid, r in
                               cst["replicas"].items()},
        },
        "failures": failures,
    }


def run_overload_scenario(cfg):
    """Overload leg: kill a replica WHILE it holds parked sessions.

    Two replicas with deliberately undersized block pools (12 rows, 2
    slots) serve a burst that oversubscribes the arenas, so the engines
    park and resume sessions through the host KV tier. The
    ``replica.kill`` fault is armed the moment a replica is OBSERVED
    holding a parked session. The router must re-dispatch everything the
    victim held — parked included — with ZERO loss and BIT-IDENTICAL
    bytes. The stream runs on the HIGH lane so the brownout ladder
    degrades but never sheds."""
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving.fleet import FleetRouter
    from paddle_tpu_torch.serving.request import Priority

    ocfg = dict(cfg, model_name="chaos_ov", slots=2, max_len=16,
                block_size=2, num_blocks=6, replicas=2,
                requests=max(8, cfg["requests"] // 2))
    rng = random.Random(f"{ocfg['seed']}-overload")
    prompts = [[rng.randrange(ocfg["vocab_size"]) for _ in range(4)]
               for _ in range(ocfg["requests"])]
    refs = offline_references(ocfg, prompts)
    factory = _factory(ocfg, make_builder(ocfg), ocfg["requests"] * 2 + 8)
    router = FleetRouter(
        replica_factory=factory, health_interval_s=0.02,
        min_replicas=ocfg["replicas"], max_replicas=ocfg["replicas"] + 1,
        autoscale=True, breaker_threshold=3,
        label=f"chaos-ov-{ocfg['seed']}",
    )
    for i in range(ocfg["replicas"]):
        router.add_replica(factory(i))
    router.start()
    responses = []
    armed = False
    victim_rank = None
    parked_at_kill = 0
    try:
        for p in prompts:
            responses.append(router.submit(
                p, max_new_tokens=ocfg["max_new"], priority=Priority.HIGH))
        deadline = time.monotonic() + 30
        while not armed and time.monotonic() < deadline:
            if all(r.done() for r in responses):
                break
            for i in range(ocfg["replicas"]):
                rep = router._replicas.get(f"r{i}")
                if rep is None:
                    continue
                st = rep.engine.entry(ocfg["model_name"], "1").stats()
                if st["parked_sessions"] >= 1:
                    victim_rank = i
                    parked_at_kill = st["parked_sessions"]
                    break
            if victim_rank is not None:
                faults.configure([{
                    "site": "replica.kill", "action": "raise",
                    "rank": victim_rank, "id": "chaos-kill-ov",
                }])
                armed = True
            else:
                time.sleep(0.001)
        if not armed and not all(r.done() for r in responses):
            victim_rank = 0
            faults.configure([{
                "site": "replica.kill", "action": "raise",
                "rank": 0, "id": "chaos-kill-ov",
            }])
            armed = True
        outs = [[int(t) for t in r.result(timeout=240)["tokens"]]
                for r in responses]
        fired = {}
        inj = faults.get_injector()
        if inj is not None:
            fired = {k: v["fired"] for k, v in inj.rule_stats().items()}
        stats = router.stats()
    finally:
        faults.reset()
        router.shutdown()

    failures = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)

    check(stats["accepted"] == ocfg["requests"],
          f"overload: accepted {stats['accepted']} != {ocfg['requests']}")
    check(stats["completed"] == stats["accepted"],
          f"overload: ZERO-LOSS VIOLATED — accepted {stats['accepted']} "
          f"completed {stats['completed']} (failed={stats['failed']})")
    bad = [i for i, (p, o) in enumerate(zip(prompts, outs))
           if o != refs[tuple(p)]]
    check(not bad, f"overload: BIT-IDENTITY VIOLATED on requests {bad[:5]}")
    killed = fired.get("chaos-kill-ov", 0)
    check(killed == 1 if armed else killed == 0,
          f"overload: replica.kill fired {killed} times (armed={armed})")
    return {
        "config": {k: ocfg[k] for k in sorted(ocfg)},
        "invariants": {
            "accepted": stats["accepted"],
            "completed": stats["completed"],
            "lost": stats["accepted"] - stats["completed"],
            "bit_identical": not bad,
            "kill_fired": killed == 1,
            "parked_at_kill": parked_at_kill,
            "victim": victim_rank,
        },
        "failures": failures,
    }


def default_cfg(args):
    return {
        "device": args.device,
        "replicas": args.replicas,
        "requests": args.requests,
        "max_new": args.max_new,
        "kill_replica": args.kill_replica,
        "seed": args.seed,
        "arrival_s": args.arrival_s,
        "vocab_size": 24,
        "hidden": 8,
        "num_layers": 1,
        "slots": 2,
        "max_len": 16,
        "model_name": "chaos",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the replicas run (default: the card)")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=18)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--kill-replica", type=int, default=1)
    # seed 2 gives the workload prompt REPEATS (13 unique of 18), so
    # prefix affinity and the prefix cache both fire
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--arrival-s", type=float, default=0.002,
                    help="open-loop inter-arrival gap")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale run + invariant asserts, both legs")
    ap.add_argument("--overload", action="store_true",
                    help="the overload leg only: kill a replica while it "
                         "holds parked sessions")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    logging.getLogger("paddle_tpu_torch.resilience.faults").setLevel(
        logging.ERROR)
    cfg = default_cfg(args)
    t0 = time.perf_counter()
    if args.overload and not args.smoke:
        ov = run_overload_scenario(cfg)
        wall = time.perf_counter() - t0
        print(json.dumps(ov, indent=1))
        if ov["failures"]:
            for f in ov["failures"]:
                print(f"CHAOS FAIL: {f}", file=sys.stderr)
            return 1
        inv = ov["invariants"]
        print(f"CHAOS_OVERLOAD_OK requests={inv['accepted']} "
              f"lost={inv['lost']} parked_at_kill={inv['parked_at_kill']} "
              f"victim=r{inv['victim']} wall={wall:.1f}s")
        return 0
    report = run_scenario(cfg)
    if args.smoke:
        ov = run_overload_scenario(cfg)
        report["overload"] = {"config": ov["config"],
                              "invariants": ov["invariants"]}
        report["failures"] = report["failures"] + ov["failures"]
    wall = time.perf_counter() - t0
    if args.as_json:
        print(json.dumps({"pass": not report["failures"], **report,
                          "wall_s": wall}))
    else:
        print(json.dumps(report, indent=1))
    if report["failures"]:
        for f in report["failures"]:
            print(f"CHAOS FAIL: {f}", file=sys.stderr)
        return 1
    inv, m = report["invariants"], report["measured"]
    print(f"CHAOS_SERVE_OK requests={inv['accepted']} lost={inv['lost']} "
          f"rerouted={m['rerouted']} scaleup_ready_s={m['scaleup_ready_s']} "
          f"p99 {m['p99_base_ms']}ms -> {m['p99_chaos_ms']}ms "
          f"wall={wall:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
