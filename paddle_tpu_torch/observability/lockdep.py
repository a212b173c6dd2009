"""Runtime lockdep witness: named locks and a lock-order graph.

The port's copy of the JAX package's ``observability/lockdep.py``. The
Linux kernel's lockdep idea, adapted to this runtime: locks belong to
named CLASSES (every ``RequestQueue`` shares the class ``serving.queue``),
and every acquisition taken while other classes are held records a
may-acquire-while-holding edge in one process-global graph. An edge that
closes a cycle, or that contradicts a ``declare_order`` hierarchy, is a
deadlock POTENTIAL and raises ``LockOrderError`` at once, even though
this particular run did not deadlock. So one single-threaded pass over
the tests proves order-consistency for every acquisition order it
exercised, with no thread race needed.

Adoption::

    from paddle_tpu_torch.observability import lockdep
    self.lock = lockdep.named_lock("serving.queue", rlock=True)

and at module scope, the INTENDED hierarchy (a violation then names the
declared rule, not just the observed inversion)::

    lockdep.declare_order("serving.queue", "decode.tenant")

The witness is env-gated: inert unless ``PADDLE_TPU_LOCKDEP=1`` (or
``enable()`` is called). Disabled, a named lock costs one module-flag
check per acquire and one stack probe per release on top of the raw
``threading`` primitive. The port's declared hierarchy is the JAX
package's, among the lock names the port has (``declared_orders()``).

Notes on semantics:

* Edges are recorded BEFORE blocking on the raw acquire, so a true ABBA
  under contention raises instead of deadlocking the test run.
* Re-entrant acquisition of the same class (RLock) adds no edges.
* ``threading.Condition(named_lock(...))`` works: the wrapper implements
  the ``_release_save``/``_acquire_restore``/``_is_owned`` protocol, and
  a ``wait()`` fully releases the witness record too.
* The stall hook (``set_stall_hook``) is a seam for stress harnesses:
  ``hook(lock name, per-class acquisition count)`` runs before every
  enabled acquire, so a harness can perturb thread schedules as a pure
  function of its seed.
"""

import os
import threading

__all__ = [
    "LockOrderError",
    "named_lock",
    "named_condition",
    "declare_order",
    "declared_orders",
    "enable",
    "enabled",
    "reset",
    "snapshot",
    "violations",
    "set_stall_hook",
    "get_stall_hook",
    "LOCKDEP_ENV",
]

LOCKDEP_ENV = "PADDLE_TPU_LOCKDEP"


class LockOrderError(RuntimeError):
    """A lock acquisition that closes a cycle in the global lock-order
    graph or violates a declared hierarchy (deadlock potential)."""


class _State:
    def __init__(self):
        self.mu = threading.Lock()   # raw on purpose: guards the graph
        self.locks = {}              # name -> {"kind", "file", "line"}
        self.edges = {}              # (a, b) -> first-witness attribution
        self.succ = {}               # a -> set of b with edge (a, b)
        self.declared = {}           # (earlier, later) -> rule string
        self.chains = []             # declared chains, declaration order
        self.violation_log = []      # every raised violation message
        self.counts = {}             # name -> acquisitions (stall-hook key)
        self.tls = threading.local()
        self.enabled = os.environ.get(LOCKDEP_ENV, "") not in ("", "0")
        self.stall_hook = None


_S = _State()


def _stack():
    st = getattr(_S.tls, "stack", None)
    if st is None:
        st = _S.tls.stack = []
    return st


def _caller():
    """file:line of the acquiring frame (first frame outside this module
    and threading.py) — edge attribution for violation messages."""
    import sys

    f = sys._getframe(2)
    here = __file__.rstrip("c")
    while f is not None:
        fn = f.f_code.co_filename
        if fn != here and not fn.endswith("threading.py"):
            return f"{os.path.relpath(fn) if fn.startswith(os.sep) else fn}" \
                   f":{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _find_path(src, dst):
    """Edge path src -> ... -> dst in the order graph, or None (DFS)."""
    stack = [(src, (src,))]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _S.succ.get(node, ()):
            if nxt == dst:
                return path + (nxt,)
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + (nxt,)))
    return None


def _violate(msg):
    _S.violation_log.append(msg)
    raise LockOrderError(msg)


def _before_acquire(name, owner):
    """Declared-order + cycle check, and edge recording, for acquiring
    `name` (lock instance identity `owner`) with the current thread's
    held stack. Runs BEFORE the raw acquire so a true inversion raises
    rather than deadlocks."""
    st = _stack()
    for ent in st:
        if ent[0] == name:
            if ent[1] == owner:
                return  # re-entrant on the SAME instance: no new info
            # two DIFFERENT instances of one class nested: a same-class
            # ABBA needs no second class (Linux lockdep's "possible
            # recursive locking"); annotate with distinct class names
            # if the nesting is intended
            _violate(
                f"same-class nesting: acquiring a second '{name}' "
                f"instance while one is already held (held chain: "
                f"{' -> '.join(e[0] for e in st)}) at {_caller()} on "
                f"thread {threading.current_thread().name}"
            )
    held = [ent[0] for ent in st]
    hook = _S.stall_hook
    if hook is not None:
        with _S.mu:
            n = _S.counts.get(name, 0) + 1
            _S.counts[name] = n
        hook(name, n)
    if not held:
        return
    where = _caller()
    thread = threading.current_thread().name
    with _S.mu:
        for h in held:
            rule = _S.declared.get((name, h))
            if rule is not None:
                _violate(
                    f"declared lock order '{rule}' violated: acquired "
                    f"'{name}' while holding '{h}' (held chain: "
                    f"{' -> '.join(held)}) at {where} on thread {thread}"
                )
            if (h, name) in _S.edges:
                continue
            path = _find_path(name, h)
            if path is not None:
                prior = []
                for a, b in zip(path, path[1:]):
                    at = _S.edges.get((a, b), {})
                    prior.append(
                        f"{a} -> {b} (first seen at {at.get('at', '?')} "
                        f"on thread {at.get('thread', '?')}, held chain "
                        f"{' -> '.join(at.get('chain', [])) or '-'})"
                    )
                _violate(
                    f"lock-order cycle: acquiring '{name}' while holding "
                    f"'{h}' (held chain: {' -> '.join(held)}) at {where} "
                    f"on thread {thread} inverts the recorded order "
                    + "; ".join(prior)
                )
            _S.edges[(h, name)] = {
                "at": where, "thread": thread, "chain": list(held),
            }
            _S.succ.setdefault(h, set()).add(name)


def _after_acquire(name, owner, count=1):
    st = _stack()
    for ent in st:
        if ent[0] == name and ent[1] == owner:
            ent[2] += count
            return
    st.append([name, owner, count])


def _after_release(name, owner):
    """Runs UNCONDITIONALLY (not gated on the enabled flag): a witness
    toggled off between acquire and release must still pop the record,
    or the stale entry fabricates held-chains when re-armed. Near-free
    when nothing was recorded."""
    st = getattr(_S.tls, "stack", None)
    if not st:
        return
    for i in range(len(st) - 1, -1, -1):
        if st[i][0] == name and st[i][1] == owner:
            st[i][2] -= 1
            if st[i][2] <= 0:
                del st[i]
            return


def _pop_all(name, owner):
    """Remove the record entirely (Condition.wait's full release);
    returns the recursion count so restore can re-push it."""
    st = getattr(_S.tls, "stack", None)
    if not st:
        return 0
    for i in range(len(st) - 1, -1, -1):
        if st[i][0] == name and st[i][1] == owner:
            count = st[i][2]
            del st[i]
            return count
    return 0


class _NamedLock:
    """A lock belonging to a named lockdep class. Instances are cheap;
    the NAME is the node in the order graph (all RequestQueues share
    'serving.queue', exactly like Linux lockdep's lock classes)."""

    __slots__ = ("name", "kind", "_raw")

    def __init__(self, name, raw, kind):
        self.name = name
        self.kind = kind
        self._raw = raw

    # -- core protocol -----------------------------------------------------
    def acquire(self, blocking=True, timeout=-1):
        if _S.enabled:
            _before_acquire(self.name, id(self))
        got = self._raw.acquire(blocking, timeout)
        if got and _S.enabled:
            _after_acquire(self.name, id(self))
        return got

    def release(self):
        self._raw.release()
        _after_release(self.name, id(self))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        fn = getattr(self._raw, "locked", None)
        if fn is not None:
            return fn()
        if self._raw.acquire(False):
            self._raw.release()
            return False
        return True

    # -- threading.Condition(lock) protocol --------------------------------
    def _is_owned(self):
        fn = getattr(self._raw, "_is_owned", None)
        if fn is not None:
            return fn()
        if self._raw.acquire(False):
            self._raw.release()
            return False
        return True

    def _release_save(self):
        count = _pop_all(self.name, id(self))
        fn = getattr(self._raw, "_release_save", None)
        if fn is not None:
            return (fn(), count)
        self._raw.release()
        return (None, count)

    def _acquire_restore(self, saved):
        # REACQUIRE FIRST, check after: Condition.wait's wake-up must
        # leave the lock held even when the order check raises, or the
        # enclosing `with cond:` __exit__ releases an un-acquired lock
        # and buries the witness's diagnostic under a RuntimeError. The
        # record is pushed in a finally for the same reason — the
        # unwinding release() must find it to pop.
        state, count = saved
        fn = getattr(self._raw, "_acquire_restore", None)
        if fn is not None:
            fn(state)
        else:
            self._raw.acquire()
        if _S.enabled:
            try:
                _before_acquire(self.name, id(self))
            finally:
                _after_acquire(self.name, id(self), max(count, 1))

    def __repr__(self):
        return f"<named_lock {self.name!r} ({self.kind}) {self._raw!r}>"


def named_lock(name, rlock=False):
    """A ``threading.Lock``/``RLock`` registered under lockdep class
    `name`. Every instance created under one name shares that graph
    node; use dotted subsystem names ('embedding.pending')."""
    name = str(name)
    kind = "rlock" if rlock else "lock"
    if name not in _S.locks:
        with _S.mu:
            if name not in _S.locks:
                at = _caller()
                _S.locks[name] = {"kind": kind, "registered_at": at}
    return _NamedLock(name, threading.RLock() if rlock else threading.Lock(),
                      kind)


def named_condition(name, lock=None):
    """A ``threading.Condition`` whose underlying lock is witnessed under
    `name` (or wraps an existing named lock)."""
    return threading.Condition(lock if lock is not None
                               else named_lock(name, rlock=True))


def declare_order(*names):
    """Declare an intended hierarchy: ``declare_order("a", "b", "c")``
    means a is acquired before b before c whenever they nest. Acquiring
    an EARLIER class while holding a LATER one raises immediately (when
    enabled), naming this declared rule — no observed cycle needed.
    Idempotent; call at module import next to the locks it governs."""
    names = [str(n) for n in names]
    if len(names) < 2:
        raise ValueError("declare_order needs at least two lock names")
    with _S.mu:
        if names not in _S.chains:
            _S.chains.append(names)
        rule = " -> ".join(names)
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                _S.declared.setdefault((names[i], names[j]), rule)
    return tuple(names)


def declared_orders():
    with _S.mu:
        return [list(c) for c in _S.chains]


def enable(on=True):
    """Flip the witness at runtime (tests / the stress harness). Call
    ``reset()`` too when starting a fresh evidence pass."""
    _S.enabled = bool(on)
    return _S.enabled


def enabled():
    return _S.enabled


def set_stall_hook(hook):
    """Install `hook(name, nth_acquisition)` called before every
    enabled acquire — the deterministic stall seam. None removes it."""
    _S.stall_hook = hook


def get_stall_hook():
    return _S.stall_hook


def reset():
    """Clear the observed graph, violation log, stall counters, and the
    CALLING thread's held stack. Declared hierarchies and the lock-name
    registry survive (they are import-time structure, not observations)."""
    with _S.mu:
        _S.edges.clear()
        _S.succ.clear()
        _S.violation_log.clear()
        _S.counts.clear()
    _S.tls.stack = []


def violations():
    with _S.mu:
        return list(_S.violation_log)


def snapshot():
    """The witnessed state: registered lock classes, the observed
    may-acquire-while-holding edges (with first-witness attribution),
    declared hierarchies, and any cycles still present in the graph
    (always [] unless violations were swallowed by the caller)."""
    with _S.mu:
        edges = sorted((a, b) for (a, b) in _S.edges)
        attributed = [
            [a, b, dict(_S.edges[(a, b)])] for a, b in edges
        ]
        locks = {n: dict(v) for n, v in _S.locks.items()}
        chains = [list(c) for c in _S.chains]
        # cycle scan over the committed graph (defensive: _before_acquire
        # refuses cycle-closing edges, so this should stay empty)
        cycles = []
        for a, b in edges:
            path = _find_path(b, a)
            if path is not None:
                cyc = list(path) + [b] if path[-1] != b else list(path)
                lo = cyc.index(min(cyc))
                cycles.append(cyc[lo:] + cyc[:lo])
        seen, uniq = set(), []
        for c in cycles:
            key = tuple(c)
            if key not in seen:
                seen.add(key)
                uniq.append(c)
    return {
        "enabled": _S.enabled,
        "locks": locks,
        "edges": [[a, b] for a, b in edges],
        "edge_witness": attributed,
        "declared": chains,
        "cycles": uniq,
        "violations": list(_S.violation_log),
    }
