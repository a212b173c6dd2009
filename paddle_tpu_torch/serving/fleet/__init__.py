"""Fleet serving: a chaos-proven request router over decode replicas.

The port of the JAX package's ``serving/fleet``. Everything below this
package serves from one process; this is the tier above it — a front-end
router over N ``GenerationEngine`` replicas (in-process handles, or
subprocess workers over a length-prefixed RPC, each a process of its own
on the card or the CPU) that turns replica death from an outage into a
re-dispatch:

* `router`  — ``FleetRouter``: prefix-affinity routing (rendezvous hash
  of the prompt's first KV block, spill to least-loaded),
  at-most-once-VISIBLE re-dispatch under the caller's original deadline,
  fleet-wide load shedding on the measured drain-rate retry-after,
  occupancy-driven scale-up/down, restart in place through a
  ``GangSupervisor``, and rolling ``(model, version)`` deploys with
  drain-before-retire.
* `replica` — ``LocalReplica`` / ``SubprocessReplica``: one transport-
  blind handle surface (submit / poll_many / heartbeat / steal_queued /
  deploy / close); the ``replica.kill`` fault site makes death
  deterministically injectable on both transports.
* `health`  — ``ReplicaHealth``: the circuit-breaker contract
  (quarantine after K consecutive failures, cooldown probe re-admission)
  under an explicit DEAD latch for hard failures.
* `worker`  — the subprocess replica entry point
  (``python -m paddle_tpu_torch.serving.fleet.worker``).
* `metrics` — ``FleetMetrics``: the acceptance/outcome accounting whose
  identity (accepted == completed + deadline + failed + drained) IS the
  zero-loss gate in ``tools/torch_chaos_serve.py``.

Locking adopts ``lockdep.named_lock``; the declared hierarchy is
``fleet.router -> serving.queue -> decode.tenant``.
"""

from paddle_tpu_torch.serving.fleet.health import ReplicaHealth
from paddle_tpu_torch.serving.fleet.metrics import FleetMetrics
from paddle_tpu_torch.serving.fleet.replica import (
    LocalReplica,
    ReplicaError,
    SubprocessReplica,
)
from paddle_tpu_torch.serving.fleet.router import FleetRouter, RoutedRequest

__all__ = [
    "FleetMetrics",
    "FleetRouter",
    "LocalReplica",
    "ReplicaError",
    "ReplicaHealth",
    "RoutedRequest",
    "SubprocessReplica",
]
