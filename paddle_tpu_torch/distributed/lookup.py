"""Remote sparse lookup: the PS pull/push inside the step, at its ops.

Reference: paddle/fluid/operators/distributed/parameter_prefetch.cc:1 and
distributed_ops/prefetch_op.cc:1 — the reference splits ids by table shard,
RPCs the rows in, and merges them back *inside the operator*, so a huge
embedding table exists only on the parameter servers. The port's copy of
the JAX package's ``distributed/lookup.py``. There, the pull and push are
``io_callback``s inside one compiled step; the port runs a step op by op,
so ``distributed_lookup_table``'s lowering pulls on the host (from the
host copy of the ids feed, which the executor keeps on the host) and
uploads the rows to the card, and ``distributed_push_sparse``'s lowering
downloads the row grads and pushes them: a host sync for each, per table
per step (``stats["uploads"]`` and ``stats["downloads"]`` count them).

Double-buffered prefetch (the reference's prefetch thread): the data driver
announces the NEXT batch's ids via `RemoteLookupContext.prefetch`; the pull
callback then finds the rows already in flight and never blocks on the
network. `PSWorker.prefetch` / `train_from_dataset` call it one batch ahead.

The context is process-global (activated by fleet.init_worker): lowering a
remote lookup with NO active context raises instead of silently computing a
local-dense answer — a ported PS program must fail loudly, not train a
different model.
"""

import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from paddle_tpu_torch.observability import lockdep
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.retry import RetryPolicy
from paddle_tpu_torch.utils.enforce import enforce

__all__ = [
    "RemoteLookupContext",
    "activate",
    "deactivate",
    "active_context",
    "set_retry_policy",
]

# Transient PS failures (connection blips, injected TransientFault) on the
# pull/push retry under the shared policy instead of killing the step. Pulls are idempotent; a retried push is
# at-least-once (the server may double-apply a grad when the error struck
# after the apply) — the same trade the reference's async PS mode makes.
_retry = RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
                     deadline_s=30.0)


def set_retry_policy(policy):
    """Swap the pull/push retry policy (None disables retries)."""
    global _retry
    old, _retry = _retry, policy
    return old


def _with_retry(fn, *args):
    if _retry is None:
        return fn(*args)
    return _retry.call(fn, *args)

_active = None
_lock = threading.Lock()

# intended hierarchy: prefetch-map lock before the push fence — today
# every use is sequential (scan under one, wait under the other), and
# the declaration keeps a future nesting honest
lockdep.declare_order("lookup.prefetch", "lookup.push")


def activate(ctx):
    global _active
    with _lock:
        _active = ctx
    return ctx


def deactivate():
    global _active
    with _lock:
        ctx, _active = _active, None
    if ctx is not None:
        ctx.close()


def active_context():
    return _active


class RemoteLookupContext:
    """Host-side bridge between the remote lookup ops and the PSClient."""

    def __init__(self, client, sparse_lr=0.1):
        self.client = client
        self.sparse_lr = sparse_lr
        self._tables = {}  # table_name -> {"table_id", "dim"}
        self._pending = {}  # (name, ids digest) -> Future
        self._pool = ThreadPoolExecutor(max_workers=8)
        self._plock = lockdep.named_lock("lookup.prefetch")
        self._push_cv = lockdep.named_condition("lookup.push")
        self._last_fence = 0
        self._closed = False
        # observability: sync pulls vs prefetch hits (tests assert on
        # these); the ops' host transfers (uploads of pulled rows,
        # downloads of row grads) and their seconds
        self.stats = {
            "pulls": 0, "prefetch_hits": 0, "pushes": 0, "stale_prefetch": 0,
            "uploads": 0, "downloads": 0, "pull_seconds": 0.0,
            "push_seconds": 0.0,
        }

    def register(self, name, table_id, dim):
        self._tables[name] = {"table_id": int(table_id), "dim": int(dim)}

    def has(self, name):
        return name in self._tables

    # -- host callbacks ----------------------------------------------------
    @staticmethod
    def _digest(ids):
        """Content key for prefetch matching, canonicalized to a FLAT
        uint64 view: the op may see another dtype and a squeezed or
        unsqueezed shape than the prefetching driver's feed — dtype,
        memory order, and trailing-1 shape differences must all hash
        identically or the prefetch silently misses (the rows are
        content-addressed; the requesting shape is reapplied at delivery
        in pull())."""
        a = np.ascontiguousarray(
            np.asarray(ids).astype(np.uint64).reshape(-1)
        )
        return (a.size, hashlib.sha1(a.tobytes()).hexdigest())

    def _pull_now(self, name, ids):
        t = self._tables[name]
        flat = np.asarray(ids).reshape(-1).astype(np.uint64)
        uniq, inv = np.unique(flat, return_inverse=True)

        def do_pull():
            faults.fire("lookup.pull")
            return self.client.pull_sparse(t["table_id"], uniq, t["dim"])

        rows = _with_retry(do_pull)
        return (
            rows[inv]
            .reshape(tuple(np.shape(ids)) + (t["dim"],))
            .astype(np.float32)
        )

    def pull(self, name, ids):
        """The lookup op's pull (by the time it runs, every push of every
        earlier step has executed — that observed push count is the
        freshness requirement for a prefetched future)."""
        key = (name, self._digest(ids))
        with self._plock:
            fence_fut = self._pending.pop(key, None)
        if fence_fut is not None:
            fence, fut = fence_fut
            with self._push_cv:
                observed = self.stats["pushes"]
            if fence == observed:
                pulled_at, rows = fut.result()
                if pulled_at >= fence:
                    self.stats["prefetch_hits"] += 1
                    # the future was announced under the DRIVER's shape;
                    # reshape to the requesting callback's (same content
                    # by digest, possibly squeezed differently)
                    return rows.reshape(
                        tuple(np.shape(ids)) + (rows.shape[-1],)
                    )
                # the background pull timed out waiting for the fence and
                # read PRE-push rows; the pushes landed afterwards, so the
                # current count looks right but the rows are stale —
                # validate the count recorded AT pull time, never the
                # count now
                self.stats["stale_prefetch"] += 1
            else:
                # mispredicted fence: the future either pulled too early
                # (stale rows) or waits on pushes this very step must
                # produce (would deadlock) — drop it and pull fresh
                self.stats["stale_prefetch"] += 1
        self.stats["pulls"] += 1
        return self._pull_now(name, ids)

    def prefetch(self, name, ids, min_push_count=0):
        """Start pulling `ids`' rows in the background; the step's pull
        collects the future by content digest.

        `min_push_count`: the pull waits until that many pushes have
        completed — announcing batch N+1's ids while step N is still in
        flight must NOT read rows that step N's backward is about to
        update (one-step-stale rows silently change the training
        trajectory). prefetch_for_program computes the fence; the pull
        callback re-validates it against the pushes actually observed and
        discards a mispredicted future."""
        ids = np.asarray(ids)
        key = (name, self._digest(ids))
        with self._plock:
            if key not in self._pending:
                self._pending[key] = (
                    min_push_count,
                    self._pool.submit(
                        self._pull_after, name, ids, min_push_count
                    ),
                )

    def next_fence(self, n_push):
        """Push count that must land before the NEXT step's pull may read:
        every earlier announced step contributes its n_push pushes even
        when they haven't executed yet."""
        with self._push_cv:
            base = max(self.stats["pushes"], self._last_fence)
            fence = base + n_push
            self._last_fence = fence
        return fence

    def _pull_after(self, name, ids, min_pushes):
        """Returns (pushes_observed_at_pull_time, rows). The observed count
        is recorded BEFORE the pull so it is a lower bound on the rows'
        freshness — pull() accepts the future only when that recorded count
        has reached the fence (a 60s-timeout early pull records a smaller
        count and is rejected instead of being served as a fresh hit)."""
        with self._push_cv:
            if min_pushes:
                # timeout fallback: a failed step would otherwise wedge
                # every later prefetch behind a push that never comes
                self._push_cv.wait_for(
                    lambda: self._closed
                    or self.stats["pushes"] >= min_pushes,
                    timeout=60,
                )
                if self._closed:
                    raise RuntimeError("remote lookup context closed")
            observed = self.stats["pushes"]
        return observed, self._pull_now(name, ids)

    def push(self, name, ids, grad):
        """Merge duplicate-id grads (sum — dense scatter-add semantics) and
        push; the server applies its optimizer rule at sparse_lr."""
        t = self._tables[name]
        flat = np.asarray(ids).reshape(-1).astype(np.uint64)
        g = np.asarray(grad, dtype=np.float32).reshape(len(flat), t["dim"])
        uniq, inv = np.unique(flat, return_inverse=True)
        merged = np.zeros((len(uniq), t["dim"]), dtype=np.float32)
        np.add.at(merged, inv, g)

        def do_push():
            faults.fire("lookup.push")
            self.client.push_sparse(t["table_id"], uniq, merged,
                                    self.sparse_lr)

        _with_retry(do_push)
        with self._push_cv:
            self.stats["pushes"] += 1
            self._push_cv.notify_all()

    def close(self):
        """Unblock waiting prefetch tasks and release the pool threads —
        a pull racing a closing PSClient must die in its future, not hit a
        closed socket later."""
        with self._push_cv:
            self._closed = True
            self._push_cv.notify_all()
        with self._plock:
            pending = list(self._pending.values())
            self._pending.clear()
        for _, fut in pending:
            fut.cancel()
        self._pool.shutdown(wait=False)


# -- module-level targets of the ops (resolve the context at CALL time so a
#    program survives worker re-init) ---------------------------------------


def _require_ctx(name):
    ctx = active_context()
    enforce(
        ctx is not None and ctx.has(name),
        f"remote table '{name}' has no active lookup context — "
        "fleet.init_worker() must run before the step executes",
    )
    return ctx


def prefetch_for_program(program, next_feed):
    """Announce the NEXT batch's ids for every remote table of
    `program`, fenced behind the in-flight step's pushes (one push per
    distributed_push_sparse op) so the prefetched rows reflect the current
    step's update. The canonical driver for Executor.train_from_dataset,
    PSWorker.prefetch, and hand-rolled training loops."""
    prog = getattr(program, "program", program)  # unwrap CompiledProgram
    tables = getattr(prog, "_remote_tables", None)
    ctx = active_context()
    if not tables or ctx is None:
        return
    n_push = sum(
        1
        for op in prog.global_block().ops
        if op.type == "distributed_push_sparse"
    )
    fence = ctx.next_fence(n_push)
    for tname, t in tables.items():
        ids = next_feed.get(t["ids"])
        if ids is None:
            continue
        ids = _host_array(ids)
        if ids.ndim >= 2 and ids.shape[-1] == 1:
            ids = ids[..., 0]
        ctx.prefetch(t.get("table_name", tname), ids, min_push_count=fence)


def _host_array(ids):
    """A host feed as numpy: a CPU tensor is viewed, never copied from a
    card (the executor and the prefetchers keep these feeds on the
    host)."""
    if hasattr(ids, "numpy"):
        enforce(ids.device.type == "cpu",
                "remote-table ids must stay on the host (a host-read feed)")
        return ids.numpy()
    return np.asarray(ids)


def pull_host(name, ids):
    return _require_ctx(name).pull(name, ids)


def push_host(name, ids, grad):
    _require_ctx(name).push(name, ids, grad)
    return ()
