"""GenerationEngine: continuous-batching decode over a paged KV arena.

The port of the JAX package's ``serving/decode/engine.py``. A fixed batch
of S slots is stepped once per model iteration through the ``[S, 1]``
decode program (Orca, OSDI'22): finished sequences retire between
iterations and admitted prompts prefill into free slots mid-flight. KV
rows live in fixed-size blocks of one flat ``[R, H]`` arena per layer per
K/V (vLLM's PagedAttention, SOSP'23); the programs see only row-index
feeds. Prompts sharing a prefix share physical blocks through the radix
index, and a shared partial block is copied on write when a sequence
diverges inside it.

Scheduling modes, each equal to the offline whole-sequence reference
(``offline_decode``, ``offline_beam``) for any admission order:

* **decode** — the ``[S, 1]`` hot path.
* **chunked prefill** — on a model built with ``chunk_tokens``, a prompt
  longer than the budget streams through the ``[1, C]`` chunk program
  ONE chunk per engine iteration, interleaved with decode steps; chunks
  the radix already holds are skipped.
* **speculative** — ``submit(draft_model=...)``: a draft entry of the
  same engine proposes ``spec_k`` tokens, the target verifies them in ONE
  prefill forward and emits the tokens its own selection picks (committed
  coupling), so the output is the target-only stream. With ``draft_kv``
  (the default) the proposals come from a slot of the draft's own arena,
  one ``[S, 1]`` draft step a token, when the draft entry can be pinned;
  otherwise from whole-prefix replays of the draft.
* **sampling** — ``submit(sampling=SamplingParams(...))``:
  temperature/top-k/top-p by Gumbel-max over a threefry stream keyed by
  the request's seed and the token's absolute index (``generate/``), in
  every mode above.
* **beam search** — ``submit(beam_width=N)``: each live hypothesis is a
  slot of the shared decode step; a fork is one more owner of the
  parent's full blocks plus a private tail block filled by a device copy
  of the parent's rows; the request reserves N slots (admission counts
  rows, not requests) and fails or finishes as a unit.
* **grammar** — ``submit(grammar=CompiledGrammar)``: the per-state
  ``[V]`` masks ride the decode step's ``DEC_MASK`` feed as data; logits
  from a prefill, a chunk or a verify are masked on the host with the
  same float32 add. Composes with every mode above.

Overload and robustness, as the JAX engine serves them: when the block
pool runs out mid-generation, a session PARKS — its private KV rows
spill to a CRC-guarded host-RAM tier (``decode/tier.py``), its slot and
blocks free — and resumes later byte-identical (a beam group parks and
resumes as a unit, in rank order; a speculative slot parks as host state
and resumes on replay proposals); a new prompt that does not fit parks
the newest decode session or waits; a tier entry that was evicted or
fails its CRC is recomputed from the committed tokens (counted in
``resume_replays``); evicted full prompt blocks are written back to the tier and
re-injected by a later chunked admission of the same prefix. A brownout
ladder (``serving/brownout.py``) trades output-invisible quality for
headroom and finally sheds non-HIGH traffic; a circuit breaker
(``serving/breaker.py``) opens after consecutive step/chunk/inject
failures and relaunches the entry (zeroed arenas, weights kept) once its
cooldown lapses. Tenants get weighted-fair (stride) dispatch inside the
strict priority lanes, with per-tenant quotas.

What runs where: the programs run eagerly through ``core/executor.py``
on the engine's place, which is ``CUDAPlace(0)`` unless the caller
passes another; the decode step's ``paged_attention`` op launches the
hand-written CUDA kernel there (the target's steps, beam and constrained
slots included, resumed sessions' too, and the draft-KV proposal steps
alike). A park gathers a session's rows of every layer on the card and
copies them to pinned host memory in one transfer; a resume uploads
them in one transfer and scatters them through the inject program. The
scheduler (slots, blocks, radix, tier, queue, tenants) and token
selection are host Python on one thread per hosted model.

Locks are lockdep-named (``observability/lockdep.py``) and taken in the
JAX engine's declared order: the queue's lock (``serving.queue``) before
the tenant table's (``decode.tenant``); a draft entry's draft lock
(``decode.draft``) before its block pool's (``decode.blocks``); the block
pool's before the radix index's and the host tier's. The fleet router's
``fleet.router`` heads the chain (``serving/fleet/router.py``).

``submit(deadline_at=)`` takes an absolute ``time.perf_counter()``
deadline, which the fleet router passes on a re-dispatch. Still refused:
``GenerationEngine(hbm_budget_mb=)`` (M12: the JAX engine sizes the arena
with ``analysis/memory.py``, which the port lacks). Not ported, with no
option to ask for it: the profiler's spans.
"""

import threading
import time
import weakref

import numpy as np
import torch

from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.places import default_place
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.observability import lockdep
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving.breaker import ReplicaBreaker
from paddle_tpu_torch.serving.brownout import BrownoutController
from paddle_tpu_torch.serving.decode.generate import (
    BeamParams,
    CompiledGrammar,
    GrammarConstraint,
    SamplingParams,
    offline_beam_decode,
    sample_token,
)
from paddle_tpu_torch.serving.decode.generate.beam import (
    finished_ranking as beam_finished_ranking,
)
from paddle_tpu_torch.serving.decode.generate.beam import select as beam_select
from paddle_tpu_torch.serving.decode.metrics import DecodeMetrics
from paddle_tpu_torch.serving.decode.model import NEG_INF, DecodeModel
from paddle_tpu_torch.serving.decode.pool import (
    BlockPool,
    PrefixCache,
    SlotPool,
    block_hashes,
    prompt_key,
)
from paddle_tpu_torch.serving.decode.tier import HostKVTier
from paddle_tpu_torch.serving.queue import RequestQueue
from paddle_tpu_torch.serving.request import (
    DeadlineExceededError,
    Priority,
    RejectedError,
    ReplicaLostError,
    RequestError,
    Response,
)

__all__ = ["GenerationEngine", "GenerationRequest"]

# The scheduler takes the queue lock, then the tenant table inside it
# (_admit_free_slots -> _pick); quota rejects estimate retry-after
# OUTSIDE _tenant_lock to keep it so. Declared so a future inversion
# names the RULE, not just the cycle.
lockdep.declare_order("serving.queue", "decode.tenant")
# Draft-KV speculation: a TARGET entry's scheduler thread takes the draft
# entry's decode.draft lock, then allocates from the draft's block pool
# inside it — the draft lock is strictly OUTSIDE the pool lock.
lockdep.declare_order("decode.draft", "decode.blocks")


class GenerationRequest:
    """One admitted generation request. ``response.result()`` yields
    ``{"tokens": int64 array}`` — the generated tokens, including the
    stop token when eos fired (beam requests add ``"beams"``: every
    finished hypothesis with its score, best first). ``draft_key`` (a
    registry ``(name, version)``) opts the request into speculative
    decoding with ``spec_k`` proposals per verify cycle, from the
    draft's own KV slot when ``draft_kv``; ``sampling`` is a
    SamplingParams or None (greedy); ``beam`` a BeamParams or None;
    ``grammar`` a CompiledGrammar or None. ``rows`` is the slot
    footprint: 1, or a beam's width (each live hypothesis holds a
    slot). ``tenant`` names the weighted-fair share it is dispatched
    under; ``dispatch_time`` is set when it leaves the queue."""

    __slots__ = ("id", "prompt", "max_new", "tenant", "priority", "deadline",
                 "submit_time", "dispatch_time", "response", "rows",
                 "draft_key", "spec_k", "sampling", "beam", "grammar",
                 "draft_kv")

    def __init__(self, rid, prompt, max_new, tenant, priority, deadline,
                 draft_key=None, spec_k=0, sampling=None, beam=None,
                 grammar=None, draft_kv=False):
        self.id = rid
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.tenant = str(tenant)
        self.priority = priority
        self.deadline = deadline
        self.submit_time = time.perf_counter()
        self.dispatch_time = None
        self.response = Response()
        self.sampling = sampling
        self.beam = beam
        self.grammar = grammar
        self.rows = beam.width if beam is not None else 1
        self.draft_key = draft_key
        self.spec_k = int(spec_k)
        self.draft_kv = bool(draft_kv)

    def expired(self, now=None):
        if self.deadline is None:
            return False
        return (now if now is not None else time.perf_counter()) > self.deadline


class _ArenaInvalidError(RuntimeError):
    """An arena update (inject) failed mid-execution: the in-place writes
    may be partial, so the whole KV pool — not just the admitting
    request — is undefined."""


class _DeferAdmission(Exception):
    """The block pool cannot hold the prompt right now but will later
    (running or parked sessions hold its blocks, or no victim could be
    parked): the request waits on ``_pending`` — never a hard failure."""


class _TenantState:
    __slots__ = ("weight", "max_in_flight", "max_queued", "in_flight",
                 "queued", "vtime")

    def __init__(self, weight=1.0, max_in_flight=None, max_queued=None):
        self.weight = float(weight)
        self.max_in_flight = max_in_flight
        self.max_queued = max_queued
        self.in_flight = 0
        self.queued = 0
        self.vtime = 0.0


class _Slot:
    """Host-side state of one live batch slot.

    ``mode`` is "decode" (stepping through the [S, 1] program), "prefill"
    (a long prompt streaming through the chunk program), "spec"
    (speculative verify cycles — holds no TARGET arena blocks) or "beam"
    (one live beam hypothesis; its group coordinates through ``beam``).
    ``blocks`` is the slot's block table; ``row_map[p]`` the physical
    arena row of position ``p`` (the device half of the table). ``d_*``
    is the draft-KV footprint of a speculative slot: its slot, blocks and
    row map ON THE DRAFT ENTRY plus ``d_cursor``, the next draft arena
    position without a committed KV row."""

    __slots__ = ("request", "mode", "cursor", "last_token", "generated",
                 "blocks", "row_map", "plen", "done", "shared_len", "toks",
                 "sampling", "grammar", "beam", "score", "seq", "d_entry",
                 "d_slot", "d_blocks", "d_row_map", "d_cursor")

    def __init__(self, request, mode="decode"):
        self.request = request
        self.mode = mode
        self.cursor = 0
        self.last_token = None
        self.generated = []
        self.blocks = []
        self.row_map = None
        self.seq = 0            # admission order (default victim policy)
        self.plen = len(request.prompt)
        self.done = 0           # chunked prefill: prompt positions landed
        self.shared_len = 0     # positions served by radix-shared blocks
        self.toks = None        # spec mode: prompt + emitted so far
        self.sampling = None    # SamplingParams (committed-stream sampling)
        self.grammar = None     # per-hypothesis GrammarConstraint
        self.beam = None        # _BeamGroup this slot belongs to
        self.score = 0.0        # beam: cumulative float64 log-prob
        self.d_entry = None     # draft-KV: the draft _ModelEntry
        self.d_slot = None
        self.d_blocks = None
        self.d_row_map = None
        self.d_cursor = 0


class _BeamGroup:
    """One beam request's shared state across its live hypothesis slots.
    ``order`` is the live slot ids in the reference's hypothesis order —
    the rank order of the last selection — so the engine breaks ties by
    the same parent index as ``offline_beam_decode``'s live list."""

    __slots__ = ("request", "width", "finished", "order", "spare")

    def __init__(self, request):
        self.request = request
        self.width = request.beam.width
        self.finished = []      # [(token list, float64 score), ...]
        self.order = []         # live slot ids, hypothesis order
        # the group RESERVES width slots for its lifetime (what
        # request.rows promised admission): a pruned hypothesis parks its
        # slot here for later forks instead of returning it to the pool,
        # so a fork never loses its slot to another admission
        self.spare = []


class _ParkedSession:
    """One preempted in-flight session waiting off the card. ``states``
    holds the live ``_Slot`` objects (host state — sampling stream,
    grammar cursor, committed tokens — travels with them untouched);
    ``keys`` the host-tier keys of each hypothesis's spilled KV rows
    (empty for spec mode, which holds no target arena rows). Resume is
    FIFO: re-acquire slots and blocks, re-inject (or recompute) the rows,
    and the session continues byte-identically."""

    __slots__ = ("request", "mode", "states", "keys", "group")

    def __init__(self, request, mode, states, keys, group=None):
        self.request = request
        self.mode = mode
        self.states = states
        self.keys = keys
        self.group = group


class _ModelEntry:
    """One hosted (model, version): programs + executor + scope + slot
    batch + block pool + its scheduler thread. All slot/arena/block
    mutation happens on the loop thread; admission hand-off goes through
    the queue. When this entry serves as another entry's draft-KV
    proposal server, the target's loop thread runs its draft programs
    under ``_draft_lock`` (taken OUTSIDE the block pool's lock, never the
    reverse)."""

    def __init__(self, engine, model, queue_depth, breaker_threshold,
                 breaker_cooldown_s, prefix_cache_size):
        self._engine = engine
        self._model = model
        self._queue = RequestQueue(queue_depth)
        self._cond = lockdep.named_condition("serving.queue",
                                             self._queue.lock)
        self._pool = SlotPool(model.slots)
        self._slots = [None] * model.slots
        self._blocks = BlockPool(model.num_blocks, model.block_size)
        self._prefix = PrefixCache(prefix_cache_size)
        # overload: the host-RAM KV tier, parked sessions, deferred
        # admissions and the brownout ladder. The pool writes registered
        # blocks back to the tier at LRU eviction (its lock, then the
        # tier's); reads go through the entry, which owns the arenas.
        self._tier = HostKVTier(capacity_bytes=engine._host_tier_bytes)
        self._blocks.attach_tier(self._tier, read_rows=self._read_block_rows)
        self._parked = []       # [_ParkedSession] FIFO
        self._pending = []      # [GenerationRequest] deferred admissions
        self._brownout = BrownoutController()
        self._bt_seen = 0       # brownout transitions already counted
        self._admit_seq = 0
        self._chunk_throttle = False
        self.victim_policy = None   # callable([slot ids]) -> slot id
        self._breaker = (
            ReplicaBreaker(breaker_threshold, breaker_cooldown_s)
            if breaker_threshold and breaker_threshold > 0 else None
        )
        # half-open relaunch latch: one rebuild per breaker episode
        self._probe_relaunched = False
        self._metrics = DecodeMetrics(
            engine_label=f"{engine.label}:{model.label}")
        self._thread = None
        self._stop = False
        self._scope = None
        self._exe = None
        self._pref_rr = 0       # round-robin cursor over prefilling slots
        # draft-KV speculation, when THIS entry serves as the draft: every
        # draft-side call from a target's loop thread holds _draft_lock;
        # _draft_pinned closes the entry to primary submissions (its own
        # loop then never touches the arena the draft steps write);
        # _draft_ok poisons the entry after a failed draft arena call —
        # its users go back to replay proposals instead of reading an
        # undefined arena
        self._draft_lock = lockdep.named_lock("decode.draft")
        self._draft_pinned = False
        self._draft_ok = True
        # the DEC_MASK feed on the device: one all-zero [S, 1, V] tensor
        # for steps with no constrained slot, and each grammar state's
        # [V] mask uploaded once (keyed by the CompiledGrammar)
        self._zero_mask = None
        self._state_masks = weakref.WeakKeyDictionary()
        self._init_plans()

    def _init_plans(self):
        m = self._model
        self._plans = {
            "step": (m.decode_program, [m.logits_fetch]),
            "prefill": (m.prefill_program,
                        [m.prefill_logits_fetch]
                        + [n for kv in m.prefill_kv_fetches for n in kv]),
            "inject": (m.inject_program, []),
        }
        if m.chunk_program is not None:
            self._plans["chunk"] = (m.chunk_program, [m.chunk_logits_fetch])

    # -- build -------------------------------------------------------------
    def build(self):
        """Run the startup program: weights (drawn from the executor's
        keys: the startup program's ``random_seed``, which a nonzero engine
        ``seed`` sets) and zeroed arenas into the scope."""
        self._scope = Scope()
        self._exe = Executor(self._engine.place)
        startup = self._model.startup_program
        if self._engine.seed:
            startup.random_seed = self._engine.seed
        self._exe.run(startup, scope=self._scope)
        return self

    def _run(self, kind, feeds):
        """Run one program against the entry scope; returns its fetches
        as tensors on the engine's device. The arenas the decode, inject
        and chunk programs write are updated in place."""
        program, fetches = self._plans[kind]
        return self._exe.run(program, feed=feeds, fetch_list=fetches,
                             scope=self._scope, return_numpy=False)

    def _reset_arenas(self):
        """Zero the KV pool and drop all slot/block state (after a failed
        arena update, whose partial writes leave the arena undefined).
        Parked sessions keep their tier entries: those are host copies
        taken before the failure."""
        m = self._model
        dev = self._engine.device
        for kn, vn in m.state_names:
            for n in (kn, vn):
                self._scope.set(n, torch.zeros((m.rows, m.hidden),
                                               dtype=torch.float32,
                                               device=dev))
        self._pool.reset()
        self._blocks.reset()
        self._slots = [None] * m.slots

    def relaunch(self):
        """The circuit breaker's replacement replica: rebuild the
        programs from the model's builder (content-identical by
        construction), zero the arenas and reset the slots, the block
        pool with its radix index, and the tier's ``blk:`` write-backs
        (the zeroed arena's radix no longer names them). The weights in
        the scope stay; queued and parked requests are served by the
        relaunched entry. (The JAX engine re-lowers its executables from
        the compile cache here; an eager port has none to rebuild.)"""
        if self._model.builder is not None:
            self._model = self._model.builder()
            self._init_plans()
        self._reset_arenas()
        self._tier.discard_prefix("blk:")
        self._metrics.incr("relaunches")

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._stop = False
        self._queue.reopen()
        self._thread = threading.Thread(
            target=self._loop, name=f"decode-{self._model.label}",
            daemon=True)
        self._thread.start()

    def shutdown(self, timeout=60.0):
        self._queue.close()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"decode loop of {self._model.label} did not drain "
                    f"within {timeout}s")
            self._thread = None

    def notify(self):
        with self._cond:
            self._cond.notify()

    # -- scheduler loop ---------------------------------------------------
    def _loop(self):
        while not self._iterate():
            pass

    def _iterate(self):
        """ONE scheduler iteration: expire, tick the brownout ladder, gate
        on the circuit breaker (wait out an open one; relaunch once when
        it half-opens), resume parked sessions and retry deferred
        admissions, admit up to the free slots, advance AT MOST ONE
        prefill chunk, run one verify cycle per speculative slot, then
        one decode step. Tests hand-step it for a deterministic
        interleaving. Returns True when the loop should exit."""
        with self._cond:
            for r in self._queue.expire():
                self._reject_expired(r)
            # shutdown drains parked sessions and deferred admissions
            # too: capacity frees as slots retire, so they resume and
            # finish rather than abandoning their futures
            if (self._stop and self._queue.empty()
                    and self._pool.active_count == 0
                    and not self._parked and not self._pending):
                return True
        self._brownout_tick()
        if self._breaker is not None and not self._stop:
            verdict, wait_s = self._breaker.gate()
            if verdict == "wait":
                with self._cond:
                    for r in self._queue.expire():
                        self._reject_expired(r)
                    if not self._stop:
                        self._cond.wait(timeout=min(wait_s, 0.1))
                return False
            if verdict == "probe" and not self._probe_relaunched:
                # the re-admission probe IS a relaunch — ONCE per
                # half-open episode (the latch); the probe STEP's outcome
                # then closes or reopens the breaker, so an idle engine
                # does not rebuild on every loop tick
                self._metrics.incr("breaker_probes")
                try:
                    self.relaunch()
                    self._probe_relaunched = True
                except Exception:
                    self._breaker_event(self._breaker.record_failure())
                    return False
        # parked sessions and deferred admissions get first claim on
        # freed capacity — FIFO, before any new pick from the queue
        admitted = self._service_parked() + self._admit_free_slots()
        progressed = self._advance_prefills() + self._advance_spec()
        if not any(st is not None and st.mode in ("decode", "beam")
                   for st in self._slots):
            # nothing decodable AND this round moved nothing: the queue is
            # empty, or everything queued waits on a tenant cap — poll,
            # don't spin
            if not admitted and not progressed:
                with self._cond:
                    if not self._stop:
                        self._cond.wait(timeout=0.02)
            return False
        self._step()
        return False

    def _reject_expired(self, request):
        """A queued request's deadline passed before any pick."""
        self._metrics.incr("deadline_missed")
        self._engine._tenant_unqueue(request.tenant)
        request.response._complete(error=DeadlineExceededError(
            "deadline expired after "
            f"{time.perf_counter() - request.submit_time:.3f}s in queue"))
        self._metrics.observe_request(request)

    def _reject(self, request, error):
        """Fail a picked request: release its tenant's in-flight
        reservation, count and complete it."""
        self._engine._tenant_unflight(request.tenant)
        self._metrics.incr("deadline_missed"
                           if isinstance(error, DeadlineExceededError)
                           else "failed")
        request.response._complete(error=error)
        self._metrics.observe_request(request)

    def _breaker_event(self, event):
        if event:
            self._metrics.incr(event)

    # -- admission (blocks + prefill/inject into a free slot) -------------
    def _admit_free_slots(self):
        picked = []
        # brownout L3+: the LOW lane's dispatch quota drops to zero —
        # queued LOW requests wait out the pressure episode
        lanes = (Priority.LANES if self._brownout.level < 3
                 else tuple(p for p in Priority.LANES if p != Priority.LOW))
        with self._cond:
            rows = 0
            while self._pool.free_count - rows > 0:
                # budget in ROWS, not requests: a beam admission claims
                # width slots (its seed and its reserved spares)
                req = self._engine._pick(
                    self._queue, max_rows=self._pool.free_count - rows,
                    lanes=lanes)
                if req is None:
                    break
                picked.append(req)
                rows += req.rows
            # the round's picks are ONE drain event for the rate EWMA
            self._queue.note_drained()
        for req in picked:
            self._engine._tenant_unqueue(req.tenant)
            if self._admit_one(req) == "deferred":
                # lockdep: ok(single writer: the scheduler thread; submit-side readers only probe emptiness (GIL-atomic) and tolerate staleness)
                self._pending.append(req)
        return len(picked)

    def _admit_one(self, req):
        """Admit one request (freshly picked or retried from
        ``_pending``) into a free slot. The pick-time tenant in-flight
        reservation is released on every terminal outcome and KEPT on
        "deferred". Returns "admitted" | "deferred" | "done" (completed or
        failed without a slot)."""
        if req.expired():
            self._reject(req, DeadlineExceededError(
                "deadline expired before prefill"))
            return "done"
        slot = self._pool.acquire()
        if slot is None:
            # only reachable on a _pending retry (fresh picks are
            # budgeted against free_count): wait for a retirement
            return "deferred"
        try:
            self._prefill_into(req, slot)
        except _DeferAdmission:
            self._pool.release(slot)
            self._slots[slot] = None
            return "deferred"
        except _ArenaInvalidError as e:
            # the arena reset frees every slot, this one (and a beam
            # group's) too; the reset arena is valid (zeroed), so the
            # round's remaining picks still admit
            self._reject(req, RequestError(
                f"request {req.id} failed in inject: {e}"))
            self._arena_lost(f"arena failure during admission: {e}")
            return "done"
        except Exception as e:  # request-attributed, not replica health
            self._pool.release(slot)
            self._slots[slot] = None
            self._reject(req, RequestError(
                f"request {req.id} failed in prefill: {e}"))
            return "done"
        return "admitted"

    def _row_of(self, st, p):
        b = st.blocks[p // self._model.block_size]
        return b.row0 + p % self._model.block_size

    def _rebuild_row_map(self, st):
        m = self._model
        bs = m.block_size
        if st.row_map is None:
            st.row_map = np.zeros(m.max_len, dtype="int64")
        for i, b in enumerate(st.blocks):
            lo = i * bs
            hi = min(lo + bs, m.max_len)
            st.row_map[lo:hi] = b.row0 + np.arange(hi - lo)

    def _acquire_blocks(self, req):
        """The prompt's block chain (radix-shared prefix + fresh blocks),
        parking victims instead of failing under exhaustion. Loud failure
        is kept for the one unfixable case — the prompt alone can never
        fit the pool. Otherwise victims are parked (spilled to the host
        tier, to resume byte-identically) until the prompt fits; when
        that is not possible now, ``_DeferAdmission`` sends the request
        to ``_pending`` with its tenant reservation intact."""
        blocks, shared_len = self._blocks.acquire_for_prompt(req.prompt)
        if blocks is not None:
            return blocks, shared_len
        m = self._model
        self._metrics.incr("blocks_exhausted")
        if (len(req.prompt) + m.block_size - 1) // m.block_size \
                > m.num_blocks:
            self._metrics.incr("blocks_failed_total")
            raise RuntimeError(
                f"block pool exhausted ({self._blocks.stats()['blocks_free']}"
                f" free of {m.num_blocks}) and the prompt alone can never "
                "fit; shorten the prompt or host the model with more blocks")
        # don't preempt on behalf of NEW work while earlier preempted
        # sessions are still waiting — they have first claim on capacity
        while blocks is None and not self._parked:
            if not self._park_victim(req):
                break
            blocks, shared_len = self._blocks.acquire_for_prompt(req.prompt)
        self._metrics.incr("blocks_parked_total")
        if blocks is None:
            self._metrics.incr("admissions_deferred")
            raise _DeferAdmission()
        return blocks, shared_len

    # -- preemption / host-tier spill / resume ----------------------------
    def _rows_to_host(self, parts):
        """Per-layer ``[(k, v)]`` row runs on the device -> the same as
        numpy arrays, through ONE device-to-host copy (into pinned memory
        on a card: the copy's end is the one sync)."""
        rows = torch.stack([torch.stack(kv) for kv in parts])  # [NL, 2, n, H]
        if rows.is_cuda:
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows)
        else:
            host = rows
        arr = host.numpy()
        return [(arr[i, 0], arr[i, 1]) for i in range(arr.shape[0])]

    def _read_block_rows(self, b):
        """Tier write-back reader: one registered block's live arena rows
        (called by the pool under its allocator lock at LRU eviction —
        before the evictee's rows can be overwritten by its successor)."""
        lo, hi = b.row0, b.row0 + b.size_used
        return self._rows_to_host(
            [(self._scope.find_var(kn)[lo:hi], self._scope.find_var(vn)[lo:hi])
             for kn, vn in self._model.state_names])

    def _read_rows(self, row_map, n):
        """One slot's KV rows ``[0:n)`` off the live arenas, per layer:
        gathered on the device, then one copy to the host."""
        idx = torch.as_tensor(np.asarray(row_map[:n], dtype=np.int64),
                              device=self._engine.device)
        return self._rows_to_host(
            [(self._scope.find_var(kn).index_select(0, idx),
              self._scope.find_var(vn).index_select(0, idx))
             for kn, vn in self._model.state_names])

    def _inject_host_rows(self, row_map, lo, runs):
        """Write host rows into the arenas through the inject program:
        ``runs`` are per-layer ``[(k, v)]`` numpy runs tiling positions
        ``[lo, hi)`` in order, landing at arena rows ``row_map[lo:hi]``.
        They go to the device in ONE copy (from pinned memory on a
        card)."""
        m = self._model
        dev = self._engine.device
        hi = lo + sum(run[0][0].shape[0] for run in runs)
        host = torch.empty((len(m.state_names), 2, hi - lo, m.hidden),
                           dtype=torch.float32,
                           pin_memory=dev.type == "cuda")
        buf = host.numpy()
        p = 0
        for run in runs:
            u = run[0][0].shape[0]
            for i, (k, v) in enumerate(run):
                buf[i, 0, p:p + u] = k
                buf[i, 1, p:p + u] = v
            p += u
        feed = torch.zeros((len(m.state_names), 2, 1, m.max_len, m.hidden),
                           dtype=torch.float32, device=dev)
        feed[:, :, 0, lo:hi].copy_(host, non_blocking=True)
        inj_rows = np.full((m.max_len,), m.rows, dtype="int64")
        inj_rows[lo:hi] = row_map[lo:hi]
        inj = {DecodeModel.INJ_ROWS: inj_rows}
        for i, (kn, vn) in enumerate(m.inject_kv_feeds):
            inj[kn] = feed[i, 0]
            inj[vn] = feed[i, 1]
        self._run("inject", inj)

    def _park_victim(self, req):
        """Pick and park one decode-mode victim to free blocks for
        ``req``. The policy is a seam (``victim_policy``: a callable from
        the candidate slot ids to one of them); the default parks the
        most recently admitted session — the oldest work is closest to
        finishing and freeing everything anyway."""
        cands = [s for s in range(self._model.slots)
                 if self._slots[s] is not None
                 and self._slots[s].mode == "decode"
                 and self._slots[s].request is not req]
        if not cands:
            return False
        if self.victim_policy is not None:
            pick = self.victim_policy(cands)
        else:
            pick = max(cands, key=lambda s: self._slots[s].seq)
        return self._park_slot(pick)

    def _spill(self, key, rows, st):
        """Put one hypothesis's spilled rows ``[0:cursor)`` into the tier
        (False: the tier cannot hold them)."""
        toks = (list(st.request.prompt) + list(st.generated))[:st.cursor]
        if not self._tier.put(key, rows, st.cursor, tokens=toks):
            return False
        self._metrics.observe("spill_bytes",
                              sum(k.nbytes + v.nbytes for k, v in rows))
        return True

    def _park_slot(self, s):
        """Preempt one live slot: spill its private KV rows ``[0:cursor)``
        to the host tier, free its blocks and slot (and draft footprint),
        and queue the session for FIFO resume. Host state (sampling
        stream, grammar cursor, committed tokens) stays on the parked
        ``_Slot`` untouched — resume is byte-identical by construction.
        Returns False when the session cannot be parked (host tier
        exhausted, or its lifetime footprint exceeds the whole pool, so
        it could never resume)."""
        st = self._slots[s]
        if st is None or st.mode not in ("decode", "spec"):
            return False
        req = st.request
        m = self._model
        if st.mode == "spec":
            # no target arena rows: the park is pure host state. The
            # draft-KV footprint (if any) is released; resume proposes by
            # replay — the same committed tokens either way
            faults.fire("decode.spill")
            self._release_draft_locked(st)
            self._slots[s] = None
            self._pool.release(s)
            # lockdep: ok(single writer: the scheduler thread; submit-side readers only probe emptiness (GIL-atomic) and tolerate staleness)
            self._parked.append(_ParkedSession(req, "spec", [st], []))
            self._metrics.incr("sessions_parked")
            return True
        need = (st.plen + req.max_new + m.block_size - 1) // m.block_size
        if need > m.num_blocks:
            return False
        key = f"park:{req.id}:0"
        t0 = time.perf_counter()
        faults.fire("decode.spill")
        if not self._spill(key, self._read_rows(st.row_map, st.cursor), st):
            return False
        self._metrics.observe("spill_seconds", time.perf_counter() - t0)
        self._slots[s] = None
        self._pool.release(s)
        self._blocks.release(st.blocks)
        st.blocks = []
        self._release_draft_locked(st)
        # lockdep: ok(single writer: the scheduler thread; submit-side readers only probe emptiness (GIL-atomic) and tolerate staleness)
        self._parked.append(_ParkedSession(req, "decode", [st], [key]))
        self._metrics.incr("sessions_parked")
        return True

    def _park_group(self, group, hyps=None):
        """Preempt a whole beam group: every hypothesis spills its rows
        (rank-keyed), the group releases ALL its slots (spares included),
        and resume rebuilds ``order`` in the same rank order — selection
        tie-breaking stays the same. ``hyps`` is ``[(state, source)]`` in
        rank order, each hypothesis's rows read from its source's slot:
        the live hypotheses by default, each its own source; after a
        selection whose forks find no block, the new hypotheses, a fork
        reading its parent's rows (the rows of the same token prefix)."""
        req = group.request
        m = self._model
        if hyps is None:
            hyps = [(self._slots[sid], self._slots[sid])
                    for sid in group.order]
        need = sum((st.cursor + m.block_size - 1) // m.block_size
                   for st, _src in hyps)
        if need > m.num_blocks:
            return False
        keys = []
        read = {}
        t0 = time.perf_counter()
        faults.fire("decode.spill")
        for rank, (st, src) in enumerate(hyps):
            key = f"park:{req.id}:{rank}"
            if id(src) not in read:
                read[id(src)] = self._read_rows(src.row_map, src.cursor)
            if not self._spill(key, read[id(src)], st):
                for k in keys:
                    # lockdep: ok(HostKVTier is internally locked — decode.tier, a leaf under decode.blocks)
                    self._tier.discard(k)
                return False
            keys.append(key)
        self._metrics.observe("spill_seconds", time.perf_counter() - t0)
        for sid, st in enumerate(self._slots):
            if st is not None and st.beam is group:
                self._slots[sid] = None
                self._pool.release(sid)
                self._blocks.release(st.blocks)
                st.blocks = []
        for sid in group.spare:
            self._pool.release(sid)
        group.spare = []
        group.order = []
        # lockdep: ok(single writer: the scheduler thread; submit-side readers only probe emptiness (GIL-atomic) and tolerate staleness)
        self._parked.append(_ParkedSession(
            req, "beam", [st for st, _src in hyps], keys, group=group))
        self._metrics.incr("sessions_parked")
        return True

    def _service_parked(self):
        """Resume parked sessions (FIFO, stop at the first that does not
        fit yet), then retry deferred admissions. Runs at the top of
        every iteration, before new picks — preempted work has first
        claim on freed capacity. A deferred beam also waits for its
        width in free slots."""
        progressed = 0
        while self._parked:
            ps = self._parked[0]
            if ps.request.expired():
                # lockdep: ok(single writer: the scheduler thread; submit-side readers only probe emptiness (GIL-atomic) and tolerate staleness)
                self._parked.pop(0)
                self._drop_parked(ps, DeadlineExceededError(
                    "deadline expired while parked under arena pressure"))
                continue
            if not self._resume_session(ps):
                break
            # lockdep: ok(single writer: the scheduler thread; submit-side readers only probe emptiness (GIL-atomic) and tolerate staleness)
            self._parked.pop(0)
            progressed += 1
        if not self._parked and self._pending:
            pend, self._pending = self._pending, []
            for req in pend:
                if (req.rows > self._pool.free_count
                        or self._admit_one(req) == "deferred"):
                    # lockdep: ok(single writer: the scheduler thread; submit-side readers only probe emptiness (GIL-atomic) and tolerate staleness)
                    self._pending.append(req)
                else:
                    progressed += 1
        return progressed

    def _drop_parked(self, ps, error):
        for key in ps.keys:
            # lockdep: ok(HostKVTier is internally locked — decode.tier, a leaf under decode.blocks)
            self._tier.discard(key)
        self._reject(ps.request, error)

    def _resume_session(self, ps):
        """Re-admit one parked session. Returns False when capacity is
        still insufficient (the caller retries next iteration); True when
        the session left the parked list — resumed, or failed with the
        rest through an arena loss during re-injection."""
        if ps.mode == "spec":
            s = self._pool.acquire()
            if s is None:
                return False
            faults.fire("decode.resume")
            self._slots[s] = ps.states[0]
            self._metrics.incr("sessions_resumed")
            return True
        if ps.mode == "decode":
            st = ps.states[0]
            s = self._pool.acquire()
            if s is None:
                return False
            blocks = self._blocks.acquire_rows(st.cursor)
            if blocks is None:
                self._pool.release(s)
                return False
            st.blocks = blocks
            st.shared_len = 0
            self._rebuild_row_map(st)
            self._slots[s] = st
            faults.fire("decode.resume")
            if not self._inject_rows(st, ps.keys[0]):
                return True     # arena lost; session rejected with the rest
            self._metrics.incr("sessions_resumed")
            return True
        # beam: every hypothesis comes back together, in rank order
        group = ps.group
        got = []
        for st in ps.states:
            s = self._pool.acquire()
            blocks = (self._blocks.acquire_rows(st.cursor)
                      if s is not None else None)
            if blocks is None:
                if s is not None:
                    self._pool.release(s)
                for s2, _st, b2 in got:
                    self._pool.release(s2)
                    self._blocks.release(b2)
                return False
            got.append((s, st, blocks))
        group.order = []
        for s, st, blocks in got:
            st.blocks = blocks
            st.shared_len = 0
            self._rebuild_row_map(st)
            self._slots[s] = st
            group.order.append(s)
        # re-establish the group's width reservation, best-effort: forks
        # need spares, and admission must not steal them back first
        while len(group.order) + len(group.spare) < group.width:
            sid = self._pool.acquire()
            if sid is None:
                break
            group.spare.append(sid)
        faults.fire("decode.resume")
        for rank, (s, st, blocks) in enumerate(got):
            if not self._inject_rows(st, ps.keys[rank]):
                for key in ps.keys:
                    # lockdep: ok(HostKVTier is internally locked — decode.tier, a leaf under decode.blocks)
                    self._tier.discard(key)
                return True     # arena lost; group rejected with the rest
        self._metrics.incr("sessions_resumed")
        return True

    def _inject_rows(self, st, key):
        """Re-inject a resumed session's KV rows ``[0:cursor)``. The tier
        entry is consumed if present and CRC-clean; otherwise (evicted or
        quarantined) the rows are RECOMPUTED from the committed tokens by
        the prefill program — a causal KV row is a pure function of its
        token prefix (bit for bit on the CPU; on a card the prefill's
        products may round the last bits otherwise than the steps that
        wrote the rows). Returns False on arena loss (``_arena_lost``
        already rejected every slot, this session included)."""
        m = self._model
        n = st.cursor
        t0 = time.perf_counter()
        # lockdep: ok(HostKVTier is internally locked — decode.tier, a leaf under decode.blocks)
        ent = self._tier.pop(key)
        try:
            if ent is not None and ent.size_used == n:
                self._inject_host_rows(st.row_map, 0, [ent.kv_rows])
                self._metrics.observe("resume_seconds",
                                      time.perf_counter() - t0)
                self._metrics.observe("resume_bytes", ent.nbytes)
                return True
            toks = (list(st.request.prompt) + list(st.generated))[:n]
            kv_rows = self._run("prefill", self._prefill_feeds(toks))[1:]
            self._metrics.incr("resume_replays")
            inj_rows = np.full((m.max_len,), m.rows, dtype="int64")
            inj_rows[:n] = st.row_map[:n]
            inj = {DecodeModel.INJ_ROWS: inj_rows}
            for i, (kn, vn) in enumerate(m.inject_kv_feeds):
                inj[kn] = kv_rows[2 * i]
                inj[vn] = kv_rows[2 * i + 1]
            self._run("inject", inj)
        except Exception as e:
            self._arena_lost(f"resume inject failure: {e}")
            return False
        return True

    def _restore_from_tier(self, st):
        """Chunked admission's host-tier fast path: contiguous full
        prompt blocks just past the radix-shared prefix whose rows were
        written back at eviction are re-INJECTED instead of running chunk
        prefill again — prefix-cache reach is bounded by host RAM, not
        the card's memory. Returns the prompt position covered through (0
        = no extension); only applies from a block boundary, since a
        shared partial tail already occupies the next block index."""
        m = self._model
        bs = m.block_size
        if st.shared_len % bs != 0:
            return 0
        hashes = block_hashes(st.request.prompt, bs)
        start = st.shared_len // bs
        ents = []
        idx = start
        while idx < len(hashes) and (idx + 1) * bs <= st.plen:
            ent = self._tier.get("blk:" + hashes[idx])
            if ent is None or ent.size_used != bs:
                break
            ents.append(ent)
            idx += 1
        if not ents:
            return 0
        try:
            self._inject_host_rows(st.row_map, start * bs,
                                   [ent.kv_rows for ent in ents])
        except Exception as e:
            raise _ArenaInvalidError(str(e)) from e
        self._metrics.incr("tier_hits", len(ents))
        return idx * bs

    # -- brownout ----------------------------------------------------------
    def _brownout_tick(self):
        """One severity evaluation per scheduler iteration. Occupancy
        saturates while anything is parked or deferred — the arena is
        over-subscribed even if the instantaneous row count dipped."""
        occ = self._blocks.stats()["occupancy"]
        if self._parked or self._pending:
            occ = 1.0
        qp = self._queue.pressure()
        self._brownout.step(occupancy=occ,
                            queue_seconds=qp["queue_seconds"],
                            deadline=qp["deadline"])
        n = len(self._brownout.transitions)
        if n > self._bt_seen:
            self._metrics.incr("brownout_transitions", n - self._bt_seen)
            self._bt_seen = n

    def _shed_confirmed(self):
        """Live pressure re-check guarding the two REJECT gates (L4 shed,
        L3 beam cap). Severity is sampled by the scheduler tick and
        decays hysteretically, so right after a burst clears it can
        overstate the instantaneous state — degrading quality on a stale
        reading is harmless, but turning a request away is not.
        Read-only: safe from the submit thread."""
        if self._parked or self._pending:
            return True
        occ = self._blocks.stats()["occupancy"]
        qp = self._queue.pressure()
        live = max(occ, qp["queue_seconds"], qp["deadline"])
        return live >= self._brownout.exit[self._brownout.level - 1]

    def _prefill_into(self, req, slot):
        m = self._model
        req.dispatch_time = time.perf_counter()
        self._admit_seq += 1
        # brownout L1/L2 shed OUTPUT-INVISIBLE work first: the committed
        # tokens are the same with or without speculation or draft-KV,
        # only the step count changes
        severity = self._brownout.level
        if req.draft_key is not None and severity < 2:
            # speculative: no TARGET arena footprint — each verify cycle
            # recomputes the KV it needs inside the (stateless) prefill.
            # With draft_kv the proposals get their own slot + blocks on
            # the DRAFT entry; a failure there falls back to replay.
            st = _Slot(req, mode="spec")
            st.seq = self._admit_seq
            st.toks = list(req.prompt)
            st.sampling = req.sampling
            if req.grammar is not None:
                st.grammar = GrammarConstraint(req.grammar)
            self._slots[slot] = st
            if req.draft_kv and severity < 1:
                draft = self._engine._entries.get(req.draft_key)
                if draft is not None:
                    self._admit_draft_kv(st, draft)
            self._metrics.incr("admitted")
            self._metrics.tenant_incr("admitted", req.tenant)
            return
        prompt = req.prompt
        plen = len(prompt)
        if "chunk" in self._plans and plen > m.chunk_tokens:
            blocks, shared_len = self._acquire_blocks(req)
            st = _Slot(req, mode="prefill")
            st.seq = self._admit_seq
            st.blocks = blocks
            st.shared_len = shared_len
            # the FINAL chunk always runs (it produces the last-position
            # logits), even when the radix or the tier served every block
            st.done = min(shared_len, plen - 1)
            self._rebuild_row_map(st)
            restored = self._restore_from_tier(st)
            if restored > st.done:
                st.done = min(restored, plen - 1)
            self._slots[slot] = st
            if req.beam is not None:
                # hold the rows admission counted while the chunks land
                self._open_beam_group(slot)
            self._metrics.incr("admitted")
            self._metrics.tenant_incr("admitted", req.tenant)
            return
        key = prompt_key(prompt)
        cached = self._prefix.get(key)
        greedy = None
        if cached is not None:
            kv_rows, logits_row = cached
            # hit/miss totals live on PrefixCache; only the per-tenant
            # series is a counter here
            self._metrics.tenant_incr("prefix_hits", req.tenant)
        else:
            t0 = time.perf_counter()
            faults.fire("decode.prefill")
            fetches = self._run("prefill", self._prefill_feeds(prompt))
            kv_rows = fetches[1:]                      # [1, L, H] each
            # clone: a view would pin the whole [1, L, V] logits buffer
            logits_row = fetches[0][0, plen - 1].clone()
            # the argmax's host copy ends the sample after the device work
            greedy = int(torch.argmax(logits_row))
            self._metrics.observe_prefill(time.perf_counter() - t0)
            self._prefix.put(key, kv_rows, logits_row)
        blocks, shared_len = self._acquire_blocks(req)
        st = _Slot(req, mode="decode")
        st.seq = self._admit_seq
        st.blocks = blocks
        st.shared_len = shared_len
        self._rebuild_row_map(st)
        if shared_len < plen:
            # inject ONLY the non-shared suffix: shared blocks already
            # hold the rows of the same tokens
            inj_rows = np.full((m.max_len,), m.rows, dtype="int64")
            inj_rows[shared_len:plen] = st.row_map[shared_len:plen]
            inj = {DecodeModel.INJ_ROWS: inj_rows}
            for i, (kn, vn) in enumerate(m.inject_kv_feeds):
                inj[kn] = kv_rows[2 * i]
                inj[vn] = kv_rows[2 * i + 1]
            try:
                faults.fire("decode.inject")
                self._run("inject", inj)
            except Exception as e:
                raise _ArenaInvalidError(str(e)) from e

        def host_rows(start, stop):
            return [(kv_rows[2 * i][0, start:stop].cpu().numpy(),
                     kv_rows[2 * i + 1][0, start:stop].cpu().numpy())
                    for i in range(len(m.state_names))]

        self._blocks.register_prompt_blocks(blocks, prompt,
                                            host_rows=host_rows)
        st.cursor = plen
        self._slots[slot] = st
        self._metrics.incr("admitted")
        self._metrics.tenant_incr("admitted", req.tenant)
        if req.beam is not None:
            self._begin_beam(slot, logits_row)
            return
        self._begin_decode(slot, logits_row, greedy)

    def _begin_decode(self, slot, logits_row, greedy=None):
        """A prefilled slot picks its first token from the prompt's
        last-position logits (masked on the host when constrained) and
        joins the decode batch."""
        st = self._slots[slot]
        req = st.request
        st.mode = "decode"
        st.sampling = req.sampling
        if req.grammar is not None:
            st.grammar = GrammarConstraint(req.grammar)
        first = self._choose_token(st, logits_row, greedy)
        st.last_token = first
        st.generated = [first]
        # the prefill's first token: counted apart from generated_tokens
        # so tokens_per_step stays a decode-step quantity (<= S)
        self._metrics.incr("prefill_tokens")
        self._metrics.tenant_incr("tokens", req.tenant)
        if self._finished(st):
            self._retire(slot)

    def _prefill_feeds(self, prompt):
        m = self._model
        toks = np.zeros((1, m.max_len), "int64")
        toks[0, :len(prompt)] = prompt
        pos = np.arange(m.max_len, dtype="int64")[None]
        bias = np.triu(np.full((m.max_len, m.max_len), NEG_INF, "float32"),
                       k=1)[None]
        return {DecodeModel.PRE_TOKENS: toks,
                DecodeModel.PRE_POSITIONS: pos,
                DecodeModel.PRE_BIAS: bias}

    # -- chunked prefill ---------------------------------------------------
    def _advance_prefills(self):
        """Process ONE budgeted chunk for ONE prefilling slot
        (round-robin): the per-iteration prompt work is bounded by
        ``chunk_tokens``, so in-flight decode slots stall for at most one
        chunk's compute per iteration."""
        m = self._model
        pref = [s for s in range(m.slots)
                if self._slots[s] is not None
                and self._slots[s].mode == "prefill"]
        if not pref:
            return 0
        # brownout L2+: halve the chunk budget (one chunk every OTHER
        # iteration) — admitted long prompts land later, but in-flight
        # decode slots keep their step cadence under pressure
        if self._brownout.level >= 2:
            self._chunk_throttle = not self._chunk_throttle
            if self._chunk_throttle:
                return 0
        s = pref[self._pref_rr % len(pref)]
        self._pref_rr += 1
        st = self._slots[s]
        req = st.request
        if req.expired():
            self._fail_slot(s, DeadlineExceededError(
                f"deadline expired during chunked prefill after "
                f"{st.done}/{st.plen} tokens"))
            return 1
        C, L, R = m.chunk_tokens, m.max_len, m.rows
        start = st.done
        stop = min(start + C, st.plen)
        real = stop - start
        toks = np.zeros((1, C), "int64")
        toks[0, :real] = req.prompt[start:stop]
        pos = np.zeros((1, C), "int64")
        pos[0, :real] = np.arange(start, stop)
        bias = np.full((1, C, L), NEG_INF, "float32")
        bias[0, :real] = np.where(
            np.arange(L)[None, :] <= (start + np.arange(real))[:, None],
            np.float32(0.0), np.float32(NEG_INF))
        wrows = np.full((C,), R, dtype="int64")
        for c in range(real):
            p = start + c
            if p >= st.shared_len:   # never rewrite radix-shared rows
                wrows[c] = st.row_map[p]
        t0 = time.perf_counter()
        try:
            faults.fire("decode.chunk")
            logits = self._run("chunk", {
                DecodeModel.CHU_TOKENS: toks,
                DecodeModel.CHU_POSITIONS: pos,
                DecodeModel.CHU_BIAS: bias,
                DecodeModel.CHU_ROWS: st.row_map,
                DecodeModel.CHU_WRITE_ROWS: wrows,
            })[0]                                    # [1, C, V]
            row = logits[0, real - 1]
            # the argmax's host copy ends the sample after the device work
            greedy = int(torch.argmax(row))
        except Exception as e:
            # the chunk writes the arenas in place: a failure leaves them
            # undefined, so every in-flight sequence is lost
            self._arena_lost(f"chunk-prefill failure: {e}")
            return 1
        self._metrics.observe_chunk(real, time.perf_counter() - t0)
        st.done = stop
        if st.done < st.plen:
            return 1
        self._blocks.register_prompt_blocks(st.blocks, req.prompt)
        st.cursor = st.plen
        if req.beam is not None:
            try:
                self._begin_beam(s, row)
            except _ArenaInvalidError as e:
                self._arena_lost(f"beam fork inject failure: {e}")
            return 1
        self._begin_decode(s, row, greedy)
        return 1

    # -- speculative decoding ----------------------------------------------
    def _advance_spec(self):
        """One draft-propose + target-verify cycle per speculative slot.
        The draft greedily proposes up to ``spec_k`` tokens; the target
        verifies ALL of them in ONE prefill forward — logits at position
        ``n-1+j`` depend only on tokens ``<= n-1+j`` (causal mask,
        exact-zero padding), so each emitted token equals what
        target-only decode would emit."""
        m = self._model
        progressed = 0
        for s in range(m.slots):
            st = self._slots[s]
            if st is None or st.mode != "spec":
                continue
            progressed += 1
            req = st.request
            if req.expired():
                self._reject_in_flight(req, DeadlineExceededError(
                    "deadline expired mid-speculation after "
                    f"{len(st.generated)} tokens"), slot=s)
                continue
            draft = self._engine._entries.get(req.draft_key)
            if draft is None:
                self._reject_in_flight(req, RequestError(
                    f"draft model {'@'.join(req.draft_key)} left the "
                    "registry mid-generation"), slot=s)
                continue
            n = len(st.toks)
            k = max(min(req.spec_k, req.max_new - len(st.generated),
                        m.max_len - n, draft.model.max_len - n), 0)
            # the verify forward and the replay proposals are stateless
            # prefills: a failure loses nothing but this request
            try:
                props = None
                if st.d_slot is not None and k > 0:
                    props = self._draft_propose_kv(st, draft, k)
                if props is None:
                    props = []
                    dtoks = list(st.toks)
                    for _ in range(k):
                        logits = draft._run(
                            "prefill", draft._prefill_feeds(dtoks))[0]
                        nxt = int(torch.argmax(logits[0, len(dtoks) - 1]))
                        props.append(nxt)
                        dtoks.append(nxt)
                    self._metrics.incr("spec_draft_steps", k)
                else:
                    dtoks = list(st.toks) + props
                self._metrics.incr("spec_proposed_tokens", k)
                t0 = time.perf_counter()
                faults.fire("decode.verify")
                logits = self._run("prefill", self._prefill_feeds(dtoks))[0]
                rows = logits[0, n - 1:n + k]                # [k + 1, V]
                # one host copy ends the sample after the device work
                greedy = torch.argmax(rows, dim=-1).tolist()
                self._metrics.observe_prefill(time.perf_counter() - t0,
                                              samples="verify_seconds")
            except Exception as e:
                self._reject_in_flight(req, RequestError(
                    f"request {req.id} failed in speculative cycle: "
                    f"{e}"), slot=s)
                continue
            self._metrics.incr("spec_target_steps")
            if self._samples(st) or st.grammar is not None:
                rows = rows.cpu().numpy()
            finished = False
            accepted_n = 0
            for j in range(k + 1):
                # COMMITTED COUPLING: the target derives ITS OWN token at
                # this position (sampled or greedy); a proposal is
                # accepted iff it equals that token, so the stream is the
                # target-only stream in every policy
                t = self._choose_token(st, rows[j], greedy[j])
                st.generated.append(t)
                st.toks.append(t)
                st.last_token = t
                self._metrics.incr("spec_emitted_tokens")
                self._metrics.tenant_incr("tokens", req.tenant)
                accepted = j < k and props[j] == t
                if accepted:
                    self._metrics.incr("spec_accepted_tokens")
                    accepted_n += 1
                if (len(st.generated) >= req.max_new
                        or (m.eos_id is not None and t == m.eos_id)
                        or len(st.toks) >= m.max_len):
                    finished = True
                    break
                if not accepted:
                    break   # t was the correction token: later positions
                            # saw the wrong draft prefix
            st.cursor = len(st.toks)
            if st.d_slot is not None:
                # roll the draft cursor back to the first position whose
                # written KV row may disagree with the committed tokens;
                # the next cycle's catch-up rewrites from there
                st.d_cursor = min(st.d_cursor, n + accepted_n)
            if finished:
                self._retire(s)
        return progressed

    # -- draft-KV speculative slots ---------------------------------------
    def _admit_draft_kv(self, st, draft):
        """Give a speculative slot its own KV slot + blocks on the DRAFT
        entry and prefill the prompt into them ONCE; every later proposal
        is then one [S, 1] draft decode step instead of a whole-prefix
        replay. Draft blocks are never radix-registered, so the proposal
        path never copies on write. Any failure falls back to replay
        proposals (counted in ``spec_draft_kv_fallbacks``), never fails
        the request."""
        if not draft._draft_ok or not draft._draft_pinned:
            return
        prompt = st.request.prompt
        d_slot = None
        blocks = None
        try:
            with draft._draft_lock:
                d_slot = draft._pool.acquire()
                if d_slot is None:
                    self._metrics.incr("spec_draft_kv_fallbacks")
                    return
                blocks, _shared = draft._blocks.acquire_for_prompt(prompt)
                if blocks is None:
                    draft._pool.release(d_slot)
                    d_slot = None
                    self._metrics.incr("spec_draft_kv_fallbacks")
                    return
                fetches = draft._run("prefill", draft._prefill_feeds(prompt))
                kv_rows = fetches[1:]
                st.d_entry = draft
                st.d_slot = d_slot
                st.d_blocks = blocks
                st.d_row_map = None
                self._rebuild_draft_row_map(draft, st)
                dm = draft.model
                plen = len(prompt)
                inj_rows = np.full((dm.max_len,), dm.rows, dtype="int64")
                inj_rows[:plen] = st.d_row_map[:plen]
                inj = {DecodeModel.INJ_ROWS: inj_rows}
                for i, (kn, vn) in enumerate(dm.inject_kv_feeds):
                    inj[kn] = kv_rows[2 * i]
                    inj[vn] = kv_rows[2 * i + 1]
                draft._run("inject", inj)
                st.d_cursor = plen
                self._metrics.incr("spec_draft_kv_prefills")
        except Exception:
            # the inject writes the draft arena in place: poison the entry
            # (all draft-KV users revert to replay) rather than trust an
            # undefined arena
            draft._draft_ok = False
            st.d_entry = None
            st.d_slot = None
            st.d_blocks = None
            st.d_row_map = None
            st.d_cursor = 0
            if blocks is not None:
                draft._blocks.release(blocks)
            if d_slot is not None:
                draft._pool.release(d_slot)
            self._metrics.incr("spec_draft_kv_fallbacks")

    def _rebuild_draft_row_map(self, draft, st):
        dm = draft.model
        bs = dm.block_size
        if st.d_row_map is None:
            st.d_row_map = np.zeros(dm.max_len, dtype="int64")
        for i, b in enumerate(st.d_blocks):
            lo = i * bs
            hi = min(lo + bs, dm.max_len)
            st.d_row_map[lo:hi] = b.row0 + np.arange(hi - lo)

    def _release_draft(self, st):
        """Return a spec slot's draft-side footprint (the caller holds the
        draft lock)."""
        draft = st.d_entry
        if draft is None:
            return
        if st.d_blocks:
            draft._blocks.release(st.d_blocks)
        if st.d_slot is not None:
            draft._pool.release(st.d_slot)
        st.d_entry = None
        st.d_slot = None
        st.d_blocks = None
        st.d_row_map = None
        st.d_cursor = 0

    def _release_draft_locked(self, st):
        draft = st.d_entry
        if draft is None:
            return
        with draft._draft_lock:
            self._release_draft(st)

    def _draft_propose_kv(self, st, draft, k):
        """Greedy draft proposals, one draft decode step a token, from
        the draft's own arena slot. Catch-up first feeds every committed
        token whose draft KV row is not written yet (at most the last
        cycle's correction and bonus positions) — the last catch-up
        step's logits give the first proposal — then each further
        proposal is one more draft step. Returns the k proposals, or None
        to make the caller fall back to replay."""
        if not draft._draft_ok:
            self._release_draft_locked(st)
            self._metrics.incr("spec_draft_kv_fallbacks")
            return None
        n = len(st.toks)
        props = []
        with draft._draft_lock:
            cur = None
            for p in range(min(st.d_cursor, n - 1), n):
                cur = self._draft_step_kv(st, draft, st.toks[p], p,
                                          write=p >= st.d_cursor)
                if cur is None:
                    return None
                st.d_cursor = max(st.d_cursor, p + 1)
            props.append(int(torch.argmax(cur)))
            for j in range(1, k):
                cur = self._draft_step_kv(st, draft, props[j - 1],
                                          n + j - 1, write=True)
                if cur is None:
                    return None
                st.d_cursor = max(st.d_cursor, n + j)
                props.append(int(torch.argmax(cur)))
        return props

    def _draft_step_kv(self, st, draft, token, p, write):
        """ONE draft decode step: feed ``token`` at position ``p`` into the
        spec slot's draft arena slot (writing KV row p when asked;
        rewriting an already-correct row writes the same bytes) and
        return the [V] logits row. Returns None after releasing the draft
        footprint when the draft pool is exhausted or the draft arena
        died — the caller reverts to replay proposals."""
        dm = draft.model
        if write:
            blocks, nb, cow = draft._blocks.ensure_appendable(
                st.d_blocks, p)
            if blocks is None or cow is not None:
                # the pool is exhausted, or p lands in a partial block the
                # draft's radix shared from its earlier primary traffic
                # (proposal slots register none): propose by replay
                if blocks is not None:
                    st.d_blocks = blocks
                self._release_draft(st)
                self._metrics.incr("spec_draft_kv_fallbacks")
                return None
            st.d_blocks = blocks
            if nb is not None:
                self._rebuild_draft_row_map(draft, st)
        S, L, R = dm.slots, dm.max_len, dm.rows
        tok = np.zeros((S, 1), "int64")
        pos = np.zeros((S, 1), "int64")
        bias = np.full((S, 1, L), NEG_INF, "float32")
        rows = np.zeros((S, L), "int64")
        wrows = np.full((S,), R, dtype="int64")
        s = st.d_slot
        tok[s, 0] = int(token)
        pos[s, 0] = p
        bias[s, 0, :p + 1] = 0.0
        rows[s] = st.d_row_map
        if write:
            b = st.d_blocks[p // dm.block_size]
            wrows[s] = b.row0 + p % dm.block_size
        feeds = {DecodeModel.DEC_TOKEN: tok, DecodeModel.DEC_POSITION: pos,
                 DecodeModel.DEC_BIAS: bias,
                 DecodeModel.DEC_ROWS: rows.reshape(-1),
                 DecodeModel.DEC_WRITE_ROWS: wrows}
        if dm.logits_mask:
            # proposals are unconstrained: the draft's cached zero mask
            feeds[DecodeModel.DEC_MASK] = draft._mask_feed([])
        try:
            # the kernel clamps a row outside [0, R) where the plain
            # version raises: checked here, as the decode step checks
            if rows.min() < 0 or rows.max() >= R:
                raise ValueError(f"draft row map outside [0, {R})")
            logits = draft._run("step", feeds)[0]
        except Exception:
            # the draft step writes the DRAFT arena in place: poison the
            # draft for every user; this request reverts to replay
            draft._draft_ok = False
            self._release_draft(st)
            self._metrics.incr("spec_draft_kv_fallbacks")
            return None
        if write:
            draft._blocks.note_append(st.d_blocks[p // dm.block_size])
        self._metrics.incr("spec_draft_kv_steps")
        return logits[s, 0]

    # -- the decode iteration ---------------------------------------------
    def _arena_lost(self, why):
        """An arena update failed: fail every in-flight sequence loudly
        (ONE completion per request, a beam group's too), drive the
        circuit breaker, and reset the arena."""
        self._metrics.incr("step_failures")
        self._probe_relaunched = False
        if self._breaker is not None:
            self._breaker_event(self._breaker.record_failure())
        for s in range(len(self._slots)):
            st = self._slots[s]
            if st is not None:      # a failed group empties all its slots
                self._fail_slot(s, ReplicaLostError(
                    f"request {st.request.id} lost to {why}"))
        self._reset_arenas()

    def _fail_slot(self, s, error):
        """Fail the request slot ``s`` serves: a beam group as a unit."""
        st = self._slots[s]
        if st.beam is not None:
            self._reject_beam_group(st.beam, error)
        else:
            self._reject_in_flight(st.request, error, slot=s)

    def _apply_cow(self, st, cow):
        """Copy-on-write landed a fresh block: re-inject the shared
        partial's retained host rows into it, then remap the slot."""
        m = self._model
        u = cow.size_used
        inj_rows = np.full((m.max_len,), m.rows, dtype="int64")
        inj_rows[:u] = cow.block.row0 + np.arange(u)
        inj = {DecodeModel.INJ_ROWS: inj_rows}
        for i, (kn, vn) in enumerate(m.inject_kv_feeds):
            karr = np.zeros((1, m.max_len, m.hidden), "float32")
            varr = np.zeros((1, m.max_len, m.hidden), "float32")
            karr[0, :u] = cow.host_rows[i][0]
            varr[0, :u] = cow.host_rows[i][1]
            inj[kn] = karr
            inj[vn] = varr
        self._run("inject", inj)
        self._rebuild_row_map(st)

    # -- generation policy (host-side selection over fetched logits) ------
    @staticmethod
    def _samples(st):
        return st.sampling is not None and not st.sampling.greedy

    @staticmethod
    def _host_row(logits_row):
        """A ``[V]`` logits row as float32 numpy on the host."""
        if torch.is_tensor(logits_row):
            logits_row = logits_row.cpu().numpy()
        return np.asarray(logits_row, dtype=np.float32).reshape(-1)

    def _choose_token(self, st, logits_row, greedy=None, device_masked=False):
        """The ONE token-selection point for non-beam paths: the grammar
        mask (added on the host unless the decode program already added
        the DEC_MASK feed — the same float32 add either way), then the
        committed-stream sampler over the row in float32 on the host when
        the slot samples, else the first index of the largest logit
        (``greedy``, when the caller already took it over the same row
        for a batch of rows), then the grammar's advance. The sampler's
        step index is the absolute emitted-token index, so a sampled
        stream replays bit for bit for any admission order, batchmates
        or slot."""
        if st.grammar is not None and not device_masked:
            logits_row = self._host_row(logits_row) + st.grammar.mask()
            greedy = None
        if self._samples(st):
            faults.fire("decode.sample")
            row = self._host_row(logits_row)
            self._metrics.incr("sampled_tokens")
            t = sample_token(row, st.sampling, len(st.generated))
        elif greedy is not None:
            t = int(greedy)
        elif torch.is_tensor(logits_row):
            t = int(torch.argmax(logits_row))
        else:
            t = int(np.argmax(logits_row))
        if st.grammar is not None:
            st.grammar.advance(t)
            self._metrics.incr("grammar_steps")
        return t

    # -- beam search (copy-on-write forks over the block arena) ------------
    def _open_beam_group(self, s):
        """Give the beam request in slot ``s`` its group and claim the
        rest of its row reservation (admission budgeted width rows)."""
        st = self._slots[s]
        group = _BeamGroup(st.request)
        st.beam = group
        group.order = [s]
        for _ in range(group.width - 1):
            sid = self._pool.acquire()
            if sid is None:
                break
            group.spare.append(sid)
        return group

    def _begin_beam(self, s, logits_row):
        """First selection of a freshly prefilled beam request: the seed
        hypothesis (empty continuation, score 0) expands into up to
        ``width`` live beams — the seed slot hosts the top survivor in
        place, the rest fork from it."""
        st = self._slots[s]
        req = st.request
        st.mode = "beam"
        st.score = 0.0
        group = st.beam if st.beam is not None else self._open_beam_group(s)
        if req.grammar is not None:
            st.grammar = GrammarConstraint(req.grammar)
        self._metrics.incr("beam_requests")
        try:
            row = self._host_row(logits_row)
            if st.grammar is not None:
                row = row + st.grammar.mask()
            self._commit_beam_selection(group, [row])
        except _ArenaInvalidError:
            raise               # the caller's arena handler owns cleanup
        except Exception as e:
            self._reject_beam_group(group, RequestError(
                f"request {req.id} failed in first beam selection: {e}"))

    def _commit_beam_selection(self, group, rows):
        """ONE beam step's bookkeeping: run the committed selection rule
        over the live hypotheses' (masked) logits rows in ``order``,
        divert EOS and length-exhausted continuations to ``finished``,
        release pruned parents, keep each parent's top continuation in
        its slot, fork the rest (refcount++ and a private tail copy), and
        re-assert block row conservation. Returns False when the group
        retired or failed (its slots are gone)."""
        m = self._model
        req = group.request
        live_ids = list(group.order)
        live = [self._slots[s] for s in live_ids]
        room = group.width - len(group.finished)
        t0 = time.perf_counter()
        sel_live, sel_fin = beam_select(
            [b.score for b in live], rows, room, m.eos_id)
        self._metrics.observe("beam_rank_seconds", time.perf_counter() - t0)
        for p, t, sc in sel_fin:
            group.finished.append((live[p].generated + [t], sc))
        survivors = []
        for p, t, sc in sel_live:
            n2 = len(live[p].generated) + 1
            if n2 >= req.max_new or live[p].plen + n2 >= m.max_len:
                group.finished.append((live[p].generated + [t], sc))
            else:
                survivors.append((p, t, sc))
        keep = {p for p, _t, _s in survivors}
        for i, sid in enumerate(live_ids):
            if i not in keep:
                self._release_beam_slot(sid, to_spare=True)
                self._metrics.incr("beam_prunes")
        # a fork needs a private tail block where its parent's cursor is
        # inside a block: when the pool cannot give them all, the group
        # parks in its post-selection state instead of failing
        firsts = set()
        tails = 0
        for p, _t, _sc in survivors:
            if p in firsts:
                tails += live[p].cursor % m.block_size != 0
            firsts.add(p)
        if tails > self._blocks.available():
            self._park_selection(group, live, survivors)
            return False
        # slot assignment keeps RANK order in group.order; children fork
        # BEFORE their parent's in-place update (deferred), so every fork
        # sees the parent's pre-step tokens, grammar state and score
        new_order = []
        taken = set()
        deferred = []
        for p, t, sc in survivors:
            if p not in taken:
                taken.add(p)
                new_order.append(live_ids[p])
                deferred.append((live[p], t, sc))
            else:
                try:
                    child = self._fork_beam(group, live[p], t, sc)
                except _ArenaInvalidError:
                    raise
                except Exception as e:
                    self._reject_beam_group(group, RequestError(
                        f"request {req.id} beam fork failed: {e}"))
                    return False
                new_order.append(child)
                self._metrics.incr("beam_forks")
        for st, t, sc in deferred:
            st.generated = st.generated + [t]
            st.last_token = t
            st.score = sc
            if st.grammar is not None:
                st.grammar.advance(t)
        group.order = new_order
        self._blocks.check_conservation()
        if len(group.finished) >= group.width or not new_order:
            self._retire_beam(group)
            return False
        return True

    def _park_selection(self, group, live, survivors):
        """Park a beam group whose selection's forks found no block: the
        new hypotheses are built on the host in rank order (a fork as
        ``_fork_beam`` would make it, a kept parent updated in place) and
        spilled with their parents' rows; resume gives each its own
        blocks. Fails the group loudly only when the host tier cannot
        hold it."""
        hyps = []
        taken = set()
        deferred = []
        for p, t, sc in survivors:
            parent = live[p]
            if p not in taken:
                taken.add(p)
                hyps.append((parent, parent))
                deferred.append((parent, t, sc))
                continue
            child = _Slot(group.request, mode="beam")
            child.beam = group
            child.plen = parent.plen
            child.shared_len = parent.shared_len
            child.cursor = parent.cursor
            child.last_token = int(t)
            child.generated = parent.generated + [int(t)]
            child.score = sc
            if parent.grammar is not None:
                child.grammar = parent.grammar.fork().advance(t)
            hyps.append((child, parent))
            self._metrics.incr("beam_forks")
        for st, t, sc in deferred:
            st.generated = st.generated + [t]
            st.last_token = t
            st.score = sc
            if st.grammar is not None:
                st.grammar.advance(t)
        self._metrics.incr("blocks_exhausted")
        if self._park_group(group, hyps):
            self._metrics.incr("blocks_parked_total")
            return
        self._metrics.incr("blocks_failed_total")
        self._reject_beam_group(group, RequestError(
            f"request {group.request.id} failed: block pool exhausted "
            "forking a beam and the host KV tier cannot absorb the group"))

    def _fork_beam(self, group, parent, token, score):
        """COW-fork one live hypothesis: a second owner of the parent's
        full blocks, a private tail block filled by a device-to-device
        copy of the parent's tail rows in every layer's K and V arena,
        and a slot (from the group's reservation) carrying the forked
        host state."""
        m = self._model
        child_blocks, nb, src = self._blocks.fork_blocks(
            parent.blocks, parent.cursor)
        if child_blocks is None:
            # unreachable after _commit_beam_selection's capacity check
            raise RuntimeError("block pool exhausted forking a beam")
        slot = group.spare.pop() if group.spare else self._pool.acquire()
        if slot is None:
            self._blocks.release(child_blocks)
            raise RuntimeError("slot pool exhausted forking a beam")
        if nb is not None:
            u = nb.size_used
            try:
                for kn, vn in m.state_names:
                    for n in (kn, vn):
                        arena = self._scope.find_var(n)
                        arena[nb.row0:nb.row0 + u].copy_(
                            arena[src.row0:src.row0 + u])
            except Exception as e:
                raise _ArenaInvalidError(str(e)) from e
        st = _Slot(group.request, mode="beam")
        st.beam = group
        st.blocks = child_blocks
        st.plen = parent.plen
        st.shared_len = parent.shared_len
        st.cursor = parent.cursor
        st.last_token = int(token)
        st.generated = parent.generated + [int(token)]
        st.score = score
        if parent.grammar is not None:
            st.grammar = parent.grammar.fork().advance(token)
        self._rebuild_row_map(st)
        self._slots[slot] = st
        return slot

    def _release_beam_slot(self, sid, to_spare=False):
        st = self._slots[sid]
        self._slots[sid] = None
        if to_spare and st is not None and st.beam is not None:
            st.beam.spare.append(sid)   # keep the group's reservation
        else:
            self._pool.release(sid)
        if st is not None and st.blocks:
            self._blocks.release(st.blocks)

    def _release_group_slots(self, group):
        for sid, st in enumerate(self._slots):
            if st is not None and st.beam is group:
                self._release_beam_slot(sid)
        for sid in group.spare:
            self._pool.release(sid)
        group.spare = []
        group.order = []

    def _retire_beam(self, group):
        self._release_group_slots(group)
        req = group.request
        ranked = beam_finished_ranking(group.finished)
        if not ranked:
            self._reject(req, RequestError(
                f"request {req.id}: beam search finished no hypothesis"))
            return
        self._engine._tenant_unflight(req.tenant)
        req.response._complete(outputs={
            "tokens": np.asarray(ranked[0][0], dtype="int64"),
            "beams": [{"tokens": np.asarray(t, dtype="int64"),
                       "score": float(sc)} for t, sc in ranked],
        })
        self._metrics.incr("completed")
        self._metrics.incr("retired")
        self._metrics.incr("beam_finished", len(ranked))
        self._metrics.tenant_incr("completed", req.tenant)
        self._metrics.observe_request(req)

    def _reject_beam_group(self, group, error):
        """Fail one beam request as a UNIT: release every slot the group
        still holds, then complete its single response once (an arena
        failure during its admission completed it already)."""
        self._release_group_slots(group)
        if not group.request.response.done():
            self._reject(group.request, error)

    # -- the decode iteration ---------------------------------------------
    def _mask_feed(self, constrained):
        """The ``[S, 1, V]`` DEC_MASK feed on the engine's device, built
        with no host sync: the cached all-zero tensor when no slot is
        constrained (``x + 0.0 == x``), else one stack of each
        constrained slot's state mask (uploaded once per grammar state)
        beside zero rows."""
        m = self._model
        if self._zero_mask is None:
            self._zero_mask = torch.zeros(
                (m.slots, 1, m.vocab_size), dtype=torch.float32,
                device=self._engine.device)
        if not constrained:
            return self._zero_mask
        rows = [self._zero_mask[s, 0] for s in range(m.slots)]
        for s, gc in constrained:
            cache = self._state_masks.setdefault(gc.grammar, {})
            mask = cache.get(gc.state)
            if mask is None:
                mask = torch.from_numpy(gc.mask()).to(self._engine.device)
                cache[gc.state] = mask
            rows[s] = mask
        return torch.stack(rows).unsqueeze(1)

    def _step(self):
        m = self._model
        S, L, R = m.slots, m.max_len, m.rows
        tok = np.zeros((S, 1), "int64")
        pos = np.zeros((S, 1), "int64")
        bias = np.full((S, 1, L), NEG_INF, "float32")
        rows = np.zeros((S, L), "int64")
        wrows = np.full((S,), R, dtype="int64")
        active = []
        groups = []         # beam groups with a live slot this step
        fed = {}            # slot -> the _Slot its feed rows belong to
        constrained = []    # (slot, GrammarConstraint) riding DEC_MASK
        for s in range(S):
            st = self._slots[s]
            if st is None or st.mode not in ("decode", "beam"):
                continue
            # make the cursor position writable: a fresh block when it
            # opens a new chunk, COW when it lands in a SHARED partial
            # tail, unregister an exclusively-owned partial before
            # mutating it
            try:
                blocks, nb, cow = self._blocks.ensure_appendable(
                    st.blocks, st.cursor)
            except RuntimeError as e:
                self._fail_slot(s, RequestError(
                    f"request {st.request.id} failed: {e}"))
                continue
            if blocks is None:
                # mid-generation exhaustion: park the session (spill to
                # the host tier, resume byte-identically later) instead
                # of failing; loud only when the host tier cannot absorb
                # it or the session can never be resumed
                self._metrics.incr("blocks_exhausted")
                parked = (self._park_group(st.beam) if st.mode == "beam"
                          else self._park_slot(s))
                if parked:
                    self._metrics.incr("blocks_parked_total")
                    continue
                self._metrics.incr("blocks_failed_total")
                self._fail_slot(s, RequestError(
                    f"request {st.request.id} failed: block pool "
                    "exhausted mid-generation and the host KV tier "
                    "cannot absorb the session"))
                continue
            st.blocks = blocks
            if cow is not None:
                try:
                    self._apply_cow(st, cow)
                except Exception as e:
                    self._arena_lost(f"copy-on-write inject failure: {e}")
                    return
            elif nb is not None:
                self._rebuild_row_map(st)
            if st.mode == "beam":
                if st.beam not in groups:
                    groups.append(st.beam)
            else:
                active.append(s)
            fed[s] = st
            tok[s, 0] = st.last_token
            pos[s, 0] = st.cursor
            bias[s, 0, :st.cursor + 1] = 0.0
            rows[s] = st.row_map
            wrows[s] = self._row_of(st, st.cursor)
            if m.logits_mask and st.grammar is not None:
                # the grammar's next-token constraint rides in as DATA:
                # the same program for every request
                constrained.append((s, st.grammar))
        for s, st in fed.items():
            if self._slots[s] is not st:
                # a beam group failed or parked after this slot was fed:
                # its blocks are free again, so it writes no row this step
                rows[s] = 0
                wrows[s] = R
                constrained = [(c, g) for c, g in constrained if c != s]
        groups = [g for g in groups
                  if g.order and not g.request.response.done()]
        if not active and not groups:
            return
        stepped = len(active) + sum(len(g.order) for g in groups)
        feeds = {DecodeModel.DEC_TOKEN: tok, DecodeModel.DEC_POSITION: pos,
                 DecodeModel.DEC_BIAS: bias,
                 DecodeModel.DEC_ROWS: rows.reshape(-1),
                 DecodeModel.DEC_WRITE_ROWS: wrows}
        t0 = time.perf_counter()
        try:
            if m.logits_mask:
                feeds[DecodeModel.DEC_MASK] = self._mask_feed(constrained)
                if constrained:
                    # a grammar state's first visit builds its mask here
                    self._metrics.observe("mask_seconds",
                                          time.perf_counter() - t0)
                    t0 = time.perf_counter()
            # the kernel clamps a row outside [0, R) where the plain
            # version raises: checked here, a bad map raises on any device
            if rows.min() < 0 or rows.max() >= R:
                raise ValueError(f"row map outside [0, {R})")
            faults.fire("decode.step")
            logits = self._run("step", feeds)[0]          # [S, 1, V]
            nxt_all = torch.argmax(logits[:, 0], dim=-1).tolist()
            beam_ids = [sid for g in groups for sid in g.order]
            # beams rank whole rows on the host: ONE copy of their rows
            beam_rows = (logits[beam_ids, 0].cpu().numpy()
                         if beam_ids else None)
        except Exception as e:
            # the step writes the arenas in place: a failure leaves them
            # undefined, so every in-flight sequence is lost
            self._arena_lost(f"decode-step failure: {e}")
            return
        now = time.perf_counter()
        self._metrics.observe_step(stepped, stepped, now - t0)
        if self._breaker is not None:
            self._breaker_event(self._breaker.record_success())
        for s in active:
            st = self._slots[s]
            self._blocks.note_append(st.blocks[st.cursor // m.block_size])
            nxt = self._choose_token(st, logits[s, 0], nxt_all[s],
                                     device_masked=m.logits_mask)
            st.generated.append(nxt)
            st.cursor += 1
            st.last_token = nxt
            self._metrics.tenant_incr("tokens", st.request.tenant)
            # finished wins over expired: the device already paid for a
            # COMPLETE generation, deliver it
            if self._finished(st):
                self._retire(s)
            elif st.request.expired(now):
                self._reject_in_flight(st.request, DeadlineExceededError(
                    "deadline expired mid-generation after "
                    f"{len(st.generated)} tokens"), slot=s)
        at = 0
        for group in groups:
            # commit this step's KV append per live hypothesis, take its
            # (device-masked) row in HYPOTHESIS order, then run the shared
            # selection rule once for the whole group
            rows_l = []
            for sid in group.order:
                bst = self._slots[sid]
                self._blocks.note_append(
                    bst.blocks[bst.cursor // m.block_size])
                bst.cursor += 1
                row = beam_rows[at]
                at += 1
                if bst.grammar is not None and not m.logits_mask:
                    row = row + bst.grammar.mask()
                rows_l.append(row)
            try:
                alive = self._commit_beam_selection(group, rows_l)
            except _ArenaInvalidError as e:
                self._arena_lost(f"beam fork inject failure: {e}")
                return
            if alive and group.request.expired(now):
                self._reject_beam_group(group, DeadlineExceededError(
                    "deadline expired mid-generation after "
                    f"{len(group.finished)} finished hypotheses"))

    def _finished(self, st):
        m = self._model
        return (len(st.generated) >= st.request.max_new
                or (m.eos_id is not None and st.last_token == m.eos_id)
                or st.cursor >= m.max_len)

    def _release_slot(self, slot):
        st = self._slots[slot]
        self._slots[slot] = None
        self._pool.release(slot)
        if st is not None:
            if st.blocks:
                self._blocks.release(st.blocks)
            self._release_draft_locked(st)

    def _retire(self, slot):
        req = self._slots[slot].request
        generated = self._slots[slot].generated
        self._release_slot(slot)
        self._engine._tenant_unflight(req.tenant)
        req.response._complete(outputs={
            "tokens": np.asarray(generated, dtype="int64"),
        })
        self._metrics.incr("completed")
        self._metrics.incr("retired")
        self._metrics.tenant_incr("completed", req.tenant)
        self._metrics.observe_request(req)

    def _reject_in_flight(self, req, error, slot=None):
        if slot is not None:
            self._release_slot(slot)
        self._reject(req, error)

    # -- reference path ----------------------------------------------------
    def offline_decode(self, prompt, max_new, sampling=None, grammar=None):
        """Offline whole-sequence reference: re-run the full causal
        prefill forward per generated token (no KV cache, no slots, no
        paged-attention kernel) with the same finish rules and the same
        selection (the grammar's mask added on the host, then
        committed-stream sampling when ``sampling`` samples, else
        greedy). Every scheduling mode is compared against THIS."""
        m = self._model
        if isinstance(sampling, dict):
            sampling = SamplingParams(**sampling)
        g = GrammarConstraint(grammar) if grammar is not None else None
        toks = list(prompt)
        out = []
        for _ in range(int(max_new)):
            t = len(toks) - 1
            row = self._run("prefill", self._prefill_feeds(toks))[0][0, t]
            if g is not None:
                row = self._host_row(row) + g.mask()
            if sampling is not None and not sampling.greedy:
                nxt = sample_token(self._host_row(row), sampling, len(out))
            elif g is not None:
                nxt = int(np.argmax(row))
            else:
                nxt = int(torch.argmax(row))
            if g is not None:
                g.advance(nxt)
            out.append(nxt)
            toks.append(nxt)
            if m.eos_id is not None and nxt == m.eos_id:
                break
            if len(toks) >= m.max_len:
                break
        return out

    def offline_beam(self, prompt, max_new, params, grammar=None):
        """Offline beam reference: ``generate.offline_beam_decode`` with
        this entry's prefill forward (the ``[1, L]`` prefill program) as
        the whole-sequence logits oracle. ``params`` is a BeamParams.
        Returns ``[(tokens, score), ...]`` best-first."""
        m = self._model

        def logits_fn(tokens):
            logits = self._run("prefill", self._prefill_feeds(tokens))[0]
            return self._host_row(logits[0, len(tokens) - 1])

        g = GrammarConstraint(grammar) if grammar is not None else None
        return offline_beam_decode(logits_fn, prompt, int(max_new), params,
                                   m.eos_id, m.max_len, grammar=g)

    def prefill_logits(self, prompt):
        """``[L, V]`` prefill logits of ``prompt`` (rows past the prompt
        are padding) — the whole-sequence reference's scores."""
        return self._run("prefill", self._prefill_feeds(list(prompt)))[0][0]

    # -- observability ----------------------------------------------------
    def stats(self):
        """The JAX engine's ``stats()`` keys but ``compile_sources`` (an
        eager port compiles no executable), plus the port's own: ``steps``
        (= ``decode_steps``), ``queue`` (the queue's own stats) and the
        raw samples (``DecodeMetrics.SAMPLES``)."""
        m = self._model
        pool = self._blocks.stats()
        spec_t = self._metrics.count("spec_target_steps")
        spec_e = self._metrics.count("spec_emitted_tokens")
        spec_p = self._metrics.count("spec_proposed_tokens")
        return self._metrics.snapshot(extra={
            **self._metrics.queue_snapshot(self._queue),
            "model": m.name, "version": m.version,
            "slots": m.slots, "max_len": m.max_len,
            "block_size": m.block_size, "num_blocks": m.num_blocks,
            "active_slots": self._pool.active_count,
            "occupancy": self._metrics.occupancy(m.slots),
            "tokens_per_step": self._metrics.tokens_per_step(),
            "arena_mib": m.arena_bytes() / 2**20,
            "slotted_equivalent_mib":
                m.slotted_equivalent_bytes() / 2**20,
            "block_pool": pool,
            "block_dedup_ratio": pool["dedup_ratio"],
            "spec_steps_per_token": (spec_t / spec_e) if spec_e else None,
            "spec_acceptance_rate": (
                self._metrics.count("spec_accepted_tokens") / spec_p
                if spec_p else None),
            "spec_draft_kv_steps_per_token": (
                self._metrics.count("spec_draft_kv_steps") / spec_e
                if spec_e else None),
            "draft_pinned": self._draft_pinned,
            "prefix_cache_entries": len(self._prefix),
            "prefix_hits": self._prefix.hits,
            "prefix_misses": self._prefix.misses,
            "breaker_state": (self._breaker.state if self._breaker
                              else None),
            "tenant_tokens": self._metrics.tenant_counts("tokens"),
            "tenant_completed": self._metrics.tenant_counts("completed"),
            "host_tier": self._tier.stats(),
            "brownout_severity": self._brownout.level,
            "brownout": self._brownout.snapshot(),
            "parked_sessions": len(self._parked),
            "pending_admissions": len(self._pending),
            "steps": self._metrics.count("decode_steps"),
            "queue": self._queue.stats(),
        })

    @property
    def metrics(self):
        return self._metrics

    @property
    def model(self):
        return self._model

    @property
    def scope(self):
        return self._scope

    @property
    def prefix_cache(self):
        return self._prefix

    @property
    def block_pool(self):
        return self._blocks


class GenerationEngine:
    """Multi-tenant front door over N hosted decode models.

    ``place`` defaults to ``CUDAPlace(0)`` and raises without a card;
    pass ``CPUPlace()`` to run on the CPU. A nonzero ``seed`` becomes the
    startup programs' ``random_seed``, from which their weights are drawn
    (``jax.random``'s values; the JAX package's engine has no such knob:
    a model's program carries it). ``breaker_threshold`` consecutive
    failed steps (or chunks, or injects) open an entry's circuit breaker
    for ``breaker_cooldown_s`` (0 turns it off); ``host_tier_mb`` is each
    entry's host-RAM KV tier budget. ``hbm_budget_mb`` raises
    ``NotImplementedError``: ROADMAP.md, M12."""

    _SEQ = 0

    def __init__(self, place=None, queue_depth=256, breaker_threshold=3,
                 breaker_cooldown_s=1.0, prefix_cache_size=64,
                 hbm_budget_mb=None, host_tier_mb=64, seed=0, label=None):
        if hbm_budget_mb is not None:
            raise NotImplementedError(
                "GenerationEngine(hbm_budget_mb=...) is not ported yet: "
                "ROADMAP.md, M12 (the JAX engine sizes the arena with "
                "analysis/memory.py)")
        self.place = default_place(place)
        self.device = self.place.device
        self.seed = int(seed)
        GenerationEngine._SEQ += 1
        self.label = label or f"genengine-{GenerationEngine._SEQ}"
        self._queue_depth = int(queue_depth)
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self._prefix_cache_size = prefix_cache_size
        # per-entry host-RAM KV tier budget (spill/write-back target)
        self._host_tier_bytes = int(host_tier_mb) << 20
        self._entries = {}        # (name, version) -> _ModelEntry
        self._latest = {}         # name -> version (last registered)
        self._reg_order = []      # keys in registration order (latest wins)
        self._tenants = {}        # tenant -> _TenantState
        self._tenant_lock = lockdep.named_lock("decode.tenant")
        self._vclock = 0.0        # engine-wide virtual time (last dispatch)
        self._started = False
        self._next_id = 0
        self._id_lock = lockdep.named_lock("decode.ids")

    # -- model registry ---------------------------------------------------
    def register_model(self, model):
        """Host one (model, version): run its startup program into a
        fresh scope on the engine's place. Returns the entry."""
        if not isinstance(model, DecodeModel):
            model = model()        # zero-arg builder
        if model.key in self._entries:
            raise ValueError(f"model {model.label} already registered")
        entry = _ModelEntry(
            self, model, self._queue_depth, self._breaker_threshold,
            self._breaker_cooldown_s, self._prefix_cache_size,
        ).build()
        self._entries[model.key] = entry
        self._latest[model.name] = model.version
        self._reg_order.append(model.key)
        if self._started:
            entry.start()
        return entry

    def unregister_model(self, name, version, timeout=60.0):
        """Retire one hosted (model, version), draining first: admission
        to the entry closes, queued and in-flight generations finish,
        THEN the entry leaves the registry. ``latest`` falls back to the
        newest still-hosted version of the name (registration order)."""
        key = (str(name), str(version))
        entry = self._entries.get(key)
        if entry is None:
            raise ValueError(
                f"no model {name}@{version} to unregister; hosted: "
                f"{['@'.join(k) for k in sorted(self._entries)]}")
        entry.shutdown(timeout)
        del self._entries[key]
        self._reg_order.remove(key)
        remaining = [v for n, v in self._reg_order if n == key[0]]
        if remaining:
            self._latest[key[0]] = remaining[-1]
        else:
            self._latest.pop(key[0], None)
        return entry

    def reroute_queued(self, name=None, version=None):
        """Pull every QUEUED (not yet prefilled) request off one entry's
        admission queue for re-dispatch elsewhere, with its original
        deadline. In-flight slots are untouched (they finish here).
        Returns the removed GenerationRequests; their responses never
        complete — the caller owns re-dispatching them."""
        entry = self._resolve(name, version)
        with entry._cond:
            reqs = entry._queue.iter_requests()
            entry._queue.reroute(reqs)
        for r in reqs:
            self._tenant_unqueue(r.tenant)
        return reqs

    def models(self):
        return sorted(self._entries)

    def entry(self, name=None, version=None):
        return self._resolve(name, version)

    def _resolve(self, name, version):
        if name is None:
            if len(self._entries) != 1:
                raise RejectedError(
                    f"engine hosts {len(self._entries)} models; submit "
                    "must name one")
            return next(iter(self._entries.values()))
        name = str(name)
        if version is None:
            version = self._latest.get(name)
        entry = self._entries.get((name, str(version)))
        if entry is None:
            raise RejectedError(
                f"no model {name}@{version}; hosted: "
                f"{['@'.join(k) for k in sorted(self._entries)]}")
        return entry

    # -- tenancy ----------------------------------------------------------
    def set_tenant(self, tenant, weight=1.0, max_in_flight=None,
                   max_queued=None):
        """Configure one tenant: scheduling weight (stride share under
        contention) and admission quotas. Unknown tenants default to
        weight 1.0, no quotas."""
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        with self._tenant_lock:
            st = self._tenants.get(str(tenant))
            if st is None:
                self._tenants[str(tenant)] = _TenantState(
                    weight, max_in_flight, max_queued)
            else:
                st.weight = float(weight)
                st.max_in_flight = max_in_flight
                st.max_queued = max_queued

    def _tenant(self, tenant):
        st = self._tenants.get(tenant)
        if st is None:
            st = _TenantState()
            self._tenants[tenant] = st
        return st

    def _tenant_unqueue(self, tenant):
        with self._tenant_lock:
            st = self._tenant(tenant)
            st.queued = max(st.queued - 1, 0)

    def _tenant_unflight(self, tenant):
        with self._tenant_lock:
            st = self._tenant(tenant)
            st.in_flight = max(st.in_flight - 1, 0)

    def _pick(self, queue, max_rows=None, lanes=None):
        """Weighted-fair pick (the caller holds ``queue.lock``): the first
        non-empty priority lane wins (strict priority), then the lane's
        queued tenant with the smallest virtual time, skipping tenants at
        their in-flight cap. The winner's FIRST queued request dispatches
        (per-tenant FIFO) and the tenant pays 1/weight virtual time.
        ``max_rows`` is the admission round's remaining slot budget: a
        tenant whose head request needs more rows (a beam) is skipped for
        the round. ``lanes`` restricts the eligible priority lanes
        (brownout L3 closes the LOW lane this way — queued LOW waits, it
        is not lost)."""
        with self._tenant_lock:
            for lane in (lanes if lanes is not None else Priority.LANES):
                requests = queue.lane(lane)
                if not requests:
                    continue
                best = None
                candidates = {}
                for r in requests:
                    if r.tenant in candidates:
                        continue
                    st = self._tenant(r.tenant)
                    if (st.max_in_flight is not None
                            and st.in_flight >= st.max_in_flight):
                        continue
                    if max_rows is not None and r.rows > max_rows:
                        # not enough free slots THIS round for the
                        # tenant's head request; its turn comes back
                        candidates[r.tenant] = None
                        continue
                    candidates[r.tenant] = (st, r)
                candidates = {t: c for t, c in candidates.items()
                              if c is not None}
                if not candidates:
                    continue  # every queued tenant here is capped
                for _tenant, (st, r) in candidates.items():
                    if best is None or st.vtime < best[0].vtime:
                        best = (st, r)
                st, req = best
                # catch-up: a long-idle tenant wins its first contested
                # pick (it IS behind) but then re-enters at the engine's
                # virtual clock instead of burning banked lag into a
                # starvation burst
                base = max(st.vtime, self._vclock)
                st.vtime = base + 1.0 / st.weight
                self._vclock = base
                # in-flight is RESERVED at pick time: a multi-slot
                # admission round calls _pick repeatedly before any
                # prefill runs
                st.in_flight += 1
                queue.remove([req], batch=True)
                return req
        return None

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._started:
            return self
        self._started = True
        for entry in self._entries.values():
            entry.start()
        return self

    def shutdown(self, timeout=60.0):
        """Graceful drain: stop admitting; queued + in-flight sequences
        finish generating before the loops exit."""
        for entry in self._entries.values():
            entry.shutdown(timeout)
        self._started = False

    drain = shutdown

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- admission --------------------------------------------------------
    def submit(self, prompt_ids, model=None, version=None, tenant="default",
               priority=Priority.NORMAL, max_new_tokens=16,
               deadline_ms=None, deadline_at=None, draft_model=None,
               draft_version=None, spec_k=4, sampling=None, beam_width=None,
               grammar=None, draft_kv=True):
        """Admit one generation request; returns its Response future
        (``result()`` -> ``{"tokens": int64 array}``, plus ``"beams"``
        for beam search). Raises RejectedError on invalid requests, an
        over-quota tenant, a full queue or a brownout shed (the last
        three with a measured retry-after). ``tenant`` names the
        weighted-fair share (``set_tenant``) the request is dispatched
        under. ``deadline_at`` is an ABSOLUTE ``time.perf_counter()``
        deadline (it wins over ``deadline_ms``): a re-dispatched request
        carries its ORIGINAL deadline through the retry instead of being
        granted a fresh budget — the fleet router's failover depends on
        this.

        ``sampling`` — a SamplingParams (or its kwargs as a dict):
        temperature/top-k/top-p on the request's committed threefry
        stream. ``draft_model`` (+ optional ``draft_version``) opts into
        speculative decoding with ``spec_k`` proposals a cycle: the draft
        must be another hosted entry sharing the target's vocabulary;
        committed coupling keeps the output the target-only stream.
        ``draft_kv`` (default on) gives the proposals their own KV slot on
        the draft entry when that entry can be PINNED (it carries no
        primary traffic, and refuses it from then on); a busy draft makes
        this request use replay proposals.

        ``beam_width`` — beam search over that many slot hypotheses
        (deterministic: refused with sampling or speculation; at most
        the entry's slots). ``grammar`` — a CompiledGrammar whose
        per-state masks constrain the output (the model needs an
        ``eos_id`` and, except on the speculative path, which masks on
        the host, ``logits_mask=True``)."""
        entry = self._resolve(model, version)
        m = entry.model
        tenant = str(tenant)
        entry.metrics.incr("submitted")
        entry.metrics.tenant_incr("submitted", tenant)
        severity = entry._brownout.level
        if (severity >= 4 and priority != Priority.HIGH
                and entry._shed_confirmed()):
            # brownout L4: the ladder's last rung — shed non-HIGH at the
            # door with a measured retry-after instead of queueing work
            # the drain rate says will miss its deadline anyway
            entry.metrics.incr("rejected")
            entry.metrics.incr("brownout_shed")
            entry.metrics.tenant_incr("rejected", tenant)
            raise RejectedError(
                f"brownout {entry._brownout.name}: shedding non-HIGH "
                "traffic under overload",
                retry_after_s=entry._queue.retry_after_estimate(1))
        self._validate(entry, prompt_ids, max_new_tokens, priority)
        if isinstance(sampling, dict):
            sampling = SamplingParams(**sampling)
        if sampling is not None and not isinstance(sampling, SamplingParams):
            self._bad(entry, "sampling must be a SamplingParams or dict")
        beam = None
        if beam_width is not None:
            beam = BeamParams(beam_width)
            if beam.width > m.slots:
                self._bad(entry,
                          f"beam width {beam.width} exceeds the entry's "
                          f"{m.slots} batch slots")
            if sampling is not None and not sampling.greedy:
                self._bad(entry, "beam search is deterministic; it does "
                                 "not compose with sampling")
            if draft_model is not None:
                self._bad(entry, "beam search does not compose with "
                                 "speculative decoding")
            if (severity >= 3 and beam.width > entry._brownout.beam_cap
                    and entry._shed_confirmed()):
                # brownout L3: wide beams multiply slot and block
                # footprint; cap NEW admissions (in-flight groups keep
                # their width)
                entry.metrics.incr("rejected")
                entry.metrics.incr("brownout_shed")
                entry.metrics.tenant_incr("rejected", tenant)
                raise RejectedError(
                    f"brownout {entry._brownout.name}: beam width capped "
                    f"at {entry._brownout.beam_cap} under pressure",
                    retry_after_s=entry._queue.retry_after_estimate(1))
        if grammar is not None:
            if not isinstance(grammar, CompiledGrammar):
                self._bad(entry, "grammar must be a CompiledGrammar")
            if m.eos_id is None:
                self._bad(entry, "grammar-constrained decode needs a "
                                 "model with an eos_id")
            if grammar.eos_id != m.eos_id:
                self._bad(entry,
                          f"grammar eos_id {grammar.eos_id} != model "
                          f"eos_id {m.eos_id}")
            if len(grammar.vocab) != m.vocab_size:
                self._bad(entry,
                          f"grammar vocab size {len(grammar.vocab)} != "
                          f"model vocab {m.vocab_size}")
            if draft_model is None and not m.logits_mask:
                self._bad(entry,
                          "grammar-constrained decode needs a model "
                          "built with logits_mask=True (the DEC_MASK "
                          "feed); only the speculative path masks "
                          "host-side")
        draft_key = None
        draft_kv = bool(draft_kv)
        if draft_model is not None:
            draft_entry = self._resolve(draft_model, draft_version)
            dm = draft_entry.model
            if dm.key == m.key:
                self._bad(entry, "draft model must differ from the target")
            if dm.vocab_size != m.vocab_size:
                self._bad(entry,
                          f"draft vocab {dm.vocab_size} != target vocab "
                          f"{m.vocab_size}")
            need = len(list(prompt_ids)) + int(max_new_tokens)
            if need > dm.max_len:
                self._bad(entry,
                          f"prompt + max_new_tokens ({need}) exceeds the "
                          f"draft model's max_len {dm.max_len}")
            if int(spec_k) < 1:
                self._bad(entry, f"spec_k must be >= 1, got {spec_k}")
            draft_key = dm.key
            if draft_kv:
                # pin the draft: draft-KV steps write the draft arena, so
                # the draft entry must carry no primary traffic. Pinning
                # is best-effort at admission (a request picked but not
                # yet slotted can slip the busy check); _draft_lock
                # serializes every spec user either way.
                with draft_entry._cond:
                    busy = (not draft_entry._queue.empty()
                            or draft_entry._pool.active_count > 0)
                    if busy and not draft_entry._draft_pinned:
                        draft_kv = False    # replay proposals, this request
                    else:
                        draft_entry._draft_pinned = True
        else:
            draft_kv = False
        with self._tenant_lock:
            st = self._tenant(tenant)
            over_quota = (st.max_queued is not None
                          and st.queued >= st.max_queued)
            quota = (st.queued, st.max_queued)
            if not over_quota:
                st.queued += 1
        if over_quota:
            # the queue lock is taken OUTSIDE the tenant lock here: the
            # scheduler takes them queue-then-tenant (_admit_free_slots
            # -> _pick), so estimating retry-after while still holding
            # the tenant lock could deadlock
            entry.metrics.incr("rejected")
            entry.metrics.incr("rejected_quota")
            entry.metrics.tenant_incr("rejected", tenant)
            raise RejectedError(
                f"tenant '{tenant}' is at its admission quota "
                f"({quota[0]}/{quota[1]} queued)",
                retry_after_s=entry._queue.retry_after_estimate(1))
        if deadline_at is not None:
            deadline = float(deadline_at)
        else:
            deadline = (time.perf_counter() + deadline_ms / 1e3
                        if deadline_ms is not None else None)
        with self._id_lock:
            self._next_id += 1
            rid = self._next_id
        req = GenerationRequest(rid, prompt_ids, max_new_tokens, tenant,
                                priority, deadline, draft_key=draft_key,
                                spec_k=spec_k, sampling=sampling, beam=beam,
                                grammar=grammar, draft_kv=draft_kv)
        with entry._cond:
            pinned = entry._draft_pinned
        if pinned:
            # a pinned draft entry serves proposals through in-place arena
            # writes — primary traffic would corrupt them
            self._tenant_unqueue(tenant)
            self._bad(entry, "entry is pinned as a draft-KV proposal "
                             "server; submit primary traffic elsewhere")
        try:
            with entry._cond:
                entry._queue.put(req)
                entry._cond.notify()
        except RejectedError:
            self._tenant_unqueue(tenant)
            entry.metrics.incr("rejected")
            entry.metrics.incr("rejected_shutdown" if entry._queue.closed()
                               else "rejected_queue_full")
            entry.metrics.tenant_incr("rejected", tenant)
            raise
        return req.response

    @staticmethod
    def _bad(entry, msg):
        entry.metrics.incr("rejected")
        entry.metrics.incr("rejected_invalid")
        raise RejectedError(msg)

    @classmethod
    def _validate(cls, entry, prompt_ids, max_new, priority):
        m = entry.model

        def bad(msg):
            cls._bad(entry, msg)

        try:
            prompt = [int(t) for t in prompt_ids]
        except (TypeError, ValueError):
            bad("prompt_ids must be a sequence of token ids")
        if priority not in Priority.LANES:
            bad(f"unknown priority {priority!r}")
        if not prompt:
            bad("empty prompt")
        if any(t < 0 or t >= m.vocab_size for t in prompt):
            bad(f"prompt token out of range [0, {m.vocab_size})")
        if int(max_new) < 1:
            bad(f"max_new_tokens must be >= 1, got {max_new}")
        if len(prompt) + int(max_new) > m.max_len:
            bad(f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds the KV arena length {m.max_len}")

    # -- observability ----------------------------------------------------
    def stats(self):
        per_model = {e.model.label: e.stats()
                     for e in self._entries.values()}
        with self._tenant_lock:
            tenants = {
                t: {"weight": st.weight, "in_flight": st.in_flight,
                    "queued": st.queued,
                    "max_in_flight": st.max_in_flight,
                    "max_queued": st.max_queued}
                for t, st in self._tenants.items()
            }
        return {
            "models": per_model,
            "tenants": tenants,
            "hosted": ["@".join(k) for k in sorted(self._entries)],
            "place": repr(self.place),
        }
