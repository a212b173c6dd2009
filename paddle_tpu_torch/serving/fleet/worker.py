"""Fleet replica worker: one decode replica in its own process.

The port's copy of the JAX package's ``serving/fleet/worker.py``. Run as
``python -m paddle_tpu_torch.serving.fleet.worker --index N ...``: the
worker builds the canonical cached-attention decoder from its CLI
geometry on ``--device`` (``cuda``, the default, or ``cpu``), registers
it with a GenerationEngine, prints one ``FLEET_WORKER_READY`` JSON line
naming its port, and serves the router's length-prefixed JSON RPC on a
single connection. There is no fallback from the card to the CPU: with
``--device cuda`` and no card the worker exits non-zero before READY.

The READY line keeps the JAX worker's keys. ``trace`` is always 0 and
``compile_sources`` all zeros: the eager port compiles no executable
(the JAX worker reports its XLA traces there). It adds ``device``.

Rolling deploys by REPLACEMENT: a builder closure cannot cross a
process boundary, so a subprocess replica never deploys in place.
Instead the worker accepts any number of ``--model-spec '{...}'`` JSON
geometries (each a (name, version) registry entry served concurrently by
the multi-tenant engine, each any of ``build_decoder_model``'s keyword
arguments over the single-model flags' defaults: ``ffn_dim`` and
``block_size`` included, so a worker can host GPT-base), and the router rolls a new version by spawning a REPLACEMENT
worker hosting old+new specs into the old worker's slot, stealing the
old worker's backlog, and drain-retiring it — then pass 2 retires the
old version from the replacement via the ``retire`` RPC (a registry
unregistration, which DOES cross the wire).

The ``stats`` RPC (the port's own) returns each hosted entry's decode
step count and step seconds and this process's kernel launch counters
(``kernel_launches``): the counters are per process, so a caller counts
a fleet's launches worker by worker.

Deadlines cross the wire as the REMAINING budget
(``deadline_budget_ms``): a ``perf_counter`` value means nothing in
another process, so the worker turns the budget back into an absolute
deadline on its own clock.

Chaos contract: the worker fires the ``replica.kill`` fault site (rank
= ``--index``) at the top of EVERY RPC it serves, so a schedule entry
``{"site": "replica.kill", "action": "kill", "rank": N, "at_call": K}``
hard-exits this process (``os._exit(43)`` — no flushes, no goodbyes) in
the middle of live traffic. The router observes the dropped connection,
marks the replica dead, and re-dispatches its in-flight requests.
"""

import argparse
import json
import os
import socket
import sys
import time


def _send(conn, obj):
    from paddle_tpu_torch.distributed.ps import frame_send

    frame_send(conn, json.dumps(obj).encode())


def _result_payload(resp):
    err = resp.error()
    if err is not None:
        return {"error": err.to_dict()}
    return {"tokens": [int(t) for t in resp.result()["tokens"]]}


def model_specs(args):
    """The (possibly several) decoder geometries this worker hosts:
    every ``--model-spec`` JSON, each defaulted from the single-model
    flags; no specs = exactly the single-model flags."""
    base = dict(vocab_size=args.vocab_size, hidden=args.hidden,
                num_layers=args.num_layers, slots=args.slots,
                max_len=args.max_len, eos_id=args.eos_id,
                name=args.name, version=args.version)
    if not args.model_spec:
        return [base]
    return [{**base, **json.loads(s)} for s in args.model_spec]


def _load(engine):
    load = 0
    for key in engine.models():
        e = engine.entry(*key)
        load += e._queue.depth() + e._pool.active_count
    return load


def _worker_stats(engine):
    from paddle_tpu_torch import kernels

    models = {}
    for key in engine.models():
        st = engine.entry(*key).stats()
        models["@".join(key)] = {
            "steps": int(st["steps"]),
            "completed": int(st.get("completed", 0)),
            "step_seconds": [float(x) for x in st.get("step_seconds", [])],
            "brownout_severity": int(st.get("brownout_severity", 0) or 0),
        }
    return {"ok": True, "pid": os.getpid(), "models": models,
            "kernel_launches": {n: int(c)
                                for n, c in kernels.launches().items()}}


def serve(args):
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving.decode import (
        GenerationEngine,
        build_decoder_model,
    )
    from paddle_tpu_torch.serving.request import Priority

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("fleet worker: --device cuda, but torch sees no CUDA "
                  "device", file=sys.stderr, flush=True)
            return 2
        place = fluid.CUDAPlace(0)
    else:
        place = fluid.CPUPlace()
    engine = GenerationEngine(
        place=place, queue_depth=args.queue_depth, breaker_threshold=0,
        label=f"fleet-worker-{args.index}",
    )
    for spec in model_specs(args):
        engine.register_model(lambda spec=spec: build_decoder_model(**spec))
    engine.start()

    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", args.port))
    srv.listen(1)
    print("FLEET_WORKER_READY " + json.dumps({
        "port": srv.getsockname()[1],
        "pid": os.getpid(),
        "models": ["@".join(k) for k in engine.models()],
        "trace": 0,
        "compile_sources": {"trace": 0, "disk": 0, "memory": 0},
        "device": str(engine.device),
    }), flush=True)

    conn, _addr = srv.accept()
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    from paddle_tpu_torch.distributed.ps import frame_recv

    tickets = {}          # ticket -> inner Response
    next_ticket = 0
    while True:
        msg = json.loads(frame_recv(conn).decode())
        # THE chaos kill site: action "kill" never returns
        faults.fire("replica.kill", rank=args.index)
        cmd = msg.get("cmd")
        if cmd == "submit":
            budget = msg.get("deadline_budget_ms")
            deadline_at = (time.perf_counter() + budget / 1e3
                           if budget is not None else None)
            try:
                resp = engine.submit(
                    msg["prompt"], model=msg.get("model"),
                    version=msg.get("version"),
                    tenant=msg.get("tenant", "default"),
                    priority=msg.get("priority", Priority.NORMAL),
                    max_new_tokens=msg.get("max_new", 16),
                    deadline_at=deadline_at,
                )
            except Exception as e:
                payload = (e.to_dict() if hasattr(e, "to_dict")
                           else {"code": "request_failed",
                                 "message": str(e)})
                _send(conn, {"ok": False, "error": payload})
                continue
            next_ticket += 1
            tickets[next_ticket] = resp
            _send(conn, {"ok": True, "ticket": next_ticket})
        elif cmd == "poll":
            done = {}
            for t in msg.get("tickets", []):
                resp = tickets.get(int(t))
                if resp is not None and resp.done():
                    done[str(t)] = _result_payload(resp)
                    del tickets[int(t)]
            _send(conn, {"done": done})
        elif cmd == "ping":
            _send(conn, {
                "ok": True, "load": _load(engine),
                "models": ["@".join(k) for k in engine.models()],
                "trace": 0,
            })
        elif cmd == "stats":
            _send(conn, _worker_stats(engine))
        elif cmd == "steal":
            stolen = []
            for key in list(engine.models()):
                for r in engine.reroute_queued(*key):
                    for t, resp in list(tickets.items()):
                        if resp is r.response:
                            stolen.append(t)
                            del tickets[t]
                            break
            _send(conn, {"tickets": stolen})
        elif cmd == "retire":
            # rolling-deploy pass 2 over the wire: drain-before-retire
            # one hosted (name, version) from the multi-tenant registry
            try:
                engine.unregister_model(
                    msg["name"], msg["version"],
                    timeout=float(msg.get("timeout", 120.0)))
            except Exception as e:
                _send(conn, {"ok": False,
                             "error": {"code": "request_failed",
                                       "message": str(e)}})
                continue
            _send(conn, {"ok": True,
                         "models": ["@".join(k) for k in engine.models()]})
        elif cmd == "stop":
            engine.shutdown()
            _send(conn, {"ok": True})
            break
        else:
            _send(conn, {"ok": False,
                         "error": {"code": "request_failed",
                                   "message": f"unknown cmd {cmd!r}"}})
    conn.close()
    srv.close()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--index", type=int, required=True,
                    help="replica index (the replica.kill rank selector)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine runs (default: the card)")
    ap.add_argument("--vocab-size", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--num-layers", type=int, default=1)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--name", type=str, default="fleet")
    ap.add_argument("--version", type=str, default="1")
    ap.add_argument("--model-spec", action="append", default=None,
                    help="JSON decoder geometry to host (repeatable; "
                         "each a (name, version) registry entry, "
                         "defaulted from the single-model flags)")
    ap.add_argument("--queue-depth", type=int, default=64)
    args = ap.parse_args(argv)
    try:
        return serve(args)
    except ConnectionError:
        # router went away: drain and exit clean (not a crash)
        return 0


if __name__ == "__main__":
    sys.exit(main())
