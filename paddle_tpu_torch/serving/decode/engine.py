"""GenerationEngine: continuous-batching greedy decode over a paged KV arena.

The port of the JAX package's ``serving/decode/engine.py``, cut down to
its greedy paged path. A fixed batch of S slots is stepped once per
model iteration through the ``[S, 1]`` decode program (Orca, OSDI'22):
finished sequences retire between iterations and admitted prompts
prefill into free slots mid-flight. KV rows live in fixed-size blocks of
one flat ``[R, H]`` arena per layer per K/V (vLLM's PagedAttention,
SOSP'23); the programs see only row-index feeds. Prompts sharing a
prefix share physical blocks through the radix index, and a shared
partial block is copied on write when a sequence diverges inside it.

What runs where: the programs run eagerly through ``core/executor.py``
on the engine's place, which is ``CUDAPlace(0)`` unless the caller
passes another; the decode step's ``paged_attention`` op launches the
hand-written CUDA kernel there. The scheduler (slots, blocks, radix,
queue) is host Python on one thread per hosted model.

Left to later work (each raises ``NotImplementedError`` at ``submit``
where a caller asks for it): chunked prefill, speculative decoding,
sampling, beam search, grammar constraints, host-tier parking and
preemption, brownout, the circuit breaker, weighted-fair tenants, the
HBM gate and the fleet router.
"""

import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.places import default_place
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.serving.decode.model import NEG_INF, DecodeModel
from paddle_tpu_torch.serving.decode.pool import (
    BlockPool,
    PrefixCache,
    SlotPool,
    prompt_key,
)
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

# submit() options of the JAX engine that this port does not serve yet,
# with the ROADMAP item that brings each
_NOT_PORTED = {
    "sampling": "M4 (sampling)",
    "beam_width": "M4 (beam search)",
    "grammar": "M4 (grammar constraints)",
    "draft_model": "M3b (speculative decoding)",
    "draft_version": "M3b (speculative decoding)",
    "spec_k": "M3b (speculative decoding)",
    "draft_kv": "M3b (speculative decoding)",
    "tenant": "M3c (weighted-fair tenants)",
    "deadline_at": "M6 (fleet re-dispatch)",
}


class GenerationRequest:
    """One admitted greedy generation request. ``response.result()``
    yields ``{"tokens": int64 array}`` — the generated tokens, including
    the stop token when eos fired."""

    __slots__ = ("id", "prompt", "max_new", "priority", "deadline",
                 "submit_time", "response", "rows")

    def __init__(self, rid, prompt, max_new, priority, deadline):
        self.id = rid
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.priority = priority
        self.deadline = deadline
        self.submit_time = time.perf_counter()
        self.response = Response()
        self.rows = 1       # queue admission unit: one batch slot

    def expired(self, now=None):
        if self.deadline is None:
            return False
        return (now if now is not None else time.perf_counter()) > self.deadline


class _ArenaInvalidError(RuntimeError):
    """An arena update (inject) failed mid-execution: the in-place writes
    may be partial, so the whole KV pool — not just the admitting
    request — is undefined."""


class _DeferAdmission(Exception):
    """The block pool cannot hold the prompt right now but will once
    running sequences retire: the request waits on ``_pending``."""


class _Slot:
    """Host-side state of one live batch slot. ``blocks`` is the slot's
    block table; ``row_map[p]`` the physical arena row of position ``p``
    (the device half of the table)."""

    __slots__ = ("request", "cursor", "last_token", "generated", "blocks",
                 "row_map", "plen", "shared_len")

    def __init__(self, request):
        self.request = request
        self.cursor = 0
        self.last_token = None
        self.generated = []
        self.blocks = []
        self.row_map = None
        self.plen = len(request.prompt)
        self.shared_len = 0     # positions served by radix-shared blocks


class _Counters:
    """Thread-safe named counters plus the step/prefill time samples the
    engine's ``stats()`` summarises (host clock; each sample ends in a
    device-to-host copy, so it includes the device work)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {}
        self.step_seconds = []
        self.prefill_seconds = []

    def incr(self, name, n=1):
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def observe(self, samples, seconds):
        with self._lock:
            samples.append(seconds)

    def snapshot(self):
        with self._lock:
            out = dict(self._counts)
            out["step_seconds"] = list(self.step_seconds)
            out["prefill_seconds"] = list(self.prefill_seconds)
        return out


class _ModelEntry:
    """One hosted (model, version): programs + executor + scope + slot
    batch + block pool + its scheduler thread. All slot/arena/block
    mutation happens on the loop thread; admission hand-off goes through
    the queue."""

    def __init__(self, engine, model, queue_depth, prefix_cache_size):
        self._engine = engine
        self._model = model
        self._queue = RequestQueue(queue_depth)
        self._cond = threading.Condition(self._queue.lock)
        self._pool = SlotPool(model.slots)
        self._slots = [None] * model.slots
        self._blocks = BlockPool(model.num_blocks, model.block_size)
        self._prefix = PrefixCache(prefix_cache_size)
        self._pending = []      # [GenerationRequest] waiting for blocks
        self._metrics = _Counters()
        self._thread = None
        self._stop = False
        self._scope = None
        self._exe = None
        m = model
        self._plans = {
            "step": (m.decode_program, [m.logits_fetch]),
            "prefill": (m.prefill_program,
                        [m.prefill_logits_fetch]
                        + [n for kv in m.prefill_kv_fetches for n in kv]),
            "inject": (m.inject_program, []),
        }

    # -- build -------------------------------------------------------------
    def build(self):
        """Run the startup program: weights (drawn from the executor's
        seeded ``torch.Generator``) and zeroed arenas into the scope."""
        self._scope = Scope()
        self._exe = Executor(self._engine.place, seed=self._engine.seed)
        self._exe.run(self._model.startup_program, scope=self._scope)
        return self

    def _run(self, kind, feeds):
        """Run one program against the entry scope; returns its fetches
        as tensors on the engine's device. The arenas the decode and
        inject programs write are updated in place."""
        program, fetches = self._plans[kind]
        return self._exe.run(program, feed=feeds, fetch_list=fetches,
                             scope=self._scope, return_numpy=False)

    def _reset_arenas(self):
        """Zero the KV pool and drop all slot/block state (after a failed
        arena update, whose partial writes leave the arena undefined)."""
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

    # -- scheduler loop ---------------------------------------------------
    def _loop(self):
        while not self._iterate():
            pass

    def _iterate(self):
        """ONE scheduler iteration: expire, admit up to the free slots,
        then one decode step. Returns True when the loop should exit."""
        with self._cond:
            for r in self._queue.expire():
                self._reject(r, DeadlineExceededError(
                    "deadline expired after "
                    f"{time.perf_counter() - r.submit_time:.3f}s in queue"))
            if (self._stop and self._queue.empty()
                    and self._pool.active_count == 0 and not self._pending):
                return True
        admitted = self._retry_pending() + self._admit_free_slots()
        if not any(st is not None for st in self._slots):
            if not admitted:
                with self._cond:
                    if not self._stop and self._queue.empty():
                        self._cond.wait(timeout=0.02)
            return False
        self._step()
        return False

    def _reject(self, request, error):
        self._metrics.incr("deadline_missed"
                           if isinstance(error, DeadlineExceededError)
                           else "failed")
        request.response._complete(error=error)

    # -- admission (blocks + prefill/inject into a free slot) -------------
    def _admit_free_slots(self):
        picked = []
        with self._cond:
            while len(picked) < self._pool.free_count:
                req = self._queue.head()
                if req is None:
                    break
                self._queue.remove([req], batch=True)
                picked.append(req)
            # the round's picks are ONE drain event for the rate EWMA
            self._queue.note_drained()
        for req in picked:
            if self._admit_one(req) == "deferred":
                self._pending.append(req)
        return len(picked)

    def _retry_pending(self):
        """Retry admissions deferred for lack of blocks, oldest first;
        stop at the first that still does not fit."""
        progressed = 0
        while self._pending:
            if self._admit_one(self._pending[0]) == "deferred":
                break
            self._pending.pop(0)
            progressed += 1
        return progressed

    def _admit_one(self, req):
        """Admit one request into a free slot. Returns "admitted" |
        "deferred" | "done" (completed or failed without a slot)."""
        if req.expired():
            self._reject(req, DeadlineExceededError(
                "deadline expired before prefill"))
            return "done"
        slot = self._pool.acquire()
        if slot is None:
            return "deferred"
        try:
            self._prefill_into(req, slot)
        except _DeferAdmission:
            self._pool.release(slot)
            self._slots[slot] = None
            return "deferred"
        except _ArenaInvalidError as e:
            self._slots[slot] = None
            self._pool.release(slot)
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
        """The prompt's block chain (radix-shared prefix + fresh blocks).
        Raises ``_DeferAdmission`` while running sequences hold the
        blocks it needs, and fails loudly when it can never fit."""
        blocks, shared_len = self._blocks.acquire_for_prompt(req.prompt)
        if blocks is not None:
            return blocks, shared_len
        m = self._model
        self._metrics.incr("blocks_exhausted")
        need = (len(req.prompt) + req.max_new + m.block_size - 1) \
            // m.block_size
        if need > m.num_blocks:
            raise RuntimeError(
                f"the request needs {need} blocks and the pool holds "
                f"{m.num_blocks}: it can never fit; shorten it or host "
                "the model with more blocks")
        raise _DeferAdmission()

    def _prefill_into(self, req, slot):
        m = self._model
        prompt = req.prompt
        plen = len(prompt)
        key = prompt_key(prompt)
        cached = self._prefix.get(key)
        if cached is not None:
            kv_rows, logits_row = cached
            first = self._choose_token(logits_row)
        else:
            t0 = time.perf_counter()
            fetches = self._run("prefill", self._prefill_feeds(prompt))
            kv_rows = fetches[1:]                      # [1, L, H] each
            # clone: a view would pin the whole [1, L, V] logits buffer
            logits_row = fetches[0][0, plen - 1].clone()
            # the argmax's host copy ends the sample after the device work
            first = self._choose_token(logits_row)
            self._metrics.observe(self._metrics.prefill_seconds,
                                  time.perf_counter() - t0)
            self._prefix.put(key, kv_rows, logits_row)
        blocks, shared_len = self._acquire_blocks(req)
        st = _Slot(req)
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
        st.last_token = first
        st.generated = [first]
        self._metrics.incr("prefill_tokens")
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

    # -- the decode iteration ---------------------------------------------
    def _arena_lost(self, why):
        """An arena update failed: fail every in-flight sequence loudly
        and reset the arena."""
        self._metrics.incr("step_failures")
        for s, st in enumerate(list(self._slots)):
            if st is not None:
                self._reject_in_flight(st.request, ReplicaLostError(
                    f"request {st.request.id} lost to {why}"), slot=s)
        self._reset_arenas()

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

    @staticmethod
    def _choose_token(logits_row):
        """Greedy selection: the first index of the largest logit."""
        return int(torch.argmax(logits_row))

    def _step(self):
        m = self._model
        S, L, R = m.slots, m.max_len, m.rows
        tok = np.zeros((S, 1), "int64")
        pos = np.zeros((S, 1), "int64")
        bias = np.full((S, 1, L), NEG_INF, "float32")
        rows = np.zeros((S, L), "int64")
        wrows = np.full((S,), R, dtype="int64")
        active = []
        for s in range(S):
            st = self._slots[s]
            if st is None:
                continue
            # make the cursor position writable: a fresh block when it
            # opens a new chunk, COW when it lands in a SHARED partial
            # tail, unregister an exclusively-owned partial before
            # mutating it
            try:
                blocks, nb, cow = self._blocks.ensure_appendable(
                    st.blocks, st.cursor)
            except RuntimeError as e:
                self._reject_in_flight(st.request, RequestError(
                    f"request {st.request.id} failed: {e}"), slot=s)
                continue
            if blocks is None:
                self._metrics.incr("blocks_exhausted")
                self._reject_in_flight(st.request, RequestError(
                    f"request {st.request.id} failed: block pool exhausted "
                    "mid-generation (preemption is not ported yet)"),
                    slot=s)
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
            active.append(s)
            tok[s, 0] = st.last_token
            pos[s, 0] = st.cursor
            bias[s, 0, :st.cursor + 1] = 0.0
            rows[s] = st.row_map
            wrows[s] = self._row_of(st, st.cursor)
        if not active:
            return
        feeds = {DecodeModel.DEC_TOKEN: tok, DecodeModel.DEC_POSITION: pos,
                 DecodeModel.DEC_BIAS: bias,
                 DecodeModel.DEC_ROWS: rows.reshape(-1),
                 DecodeModel.DEC_WRITE_ROWS: wrows}
        if m.logits_mask:
            feeds[DecodeModel.DEC_MASK] = np.zeros((S, 1, m.vocab_size),
                                                   "float32")
        t0 = time.perf_counter()
        try:
            # the kernel clamps a row outside [0, R) where the plain
            # version raises: checked here, a bad map raises on any device
            if rows.min() < 0 or rows.max() >= R:
                raise ValueError(f"row map outside [0, {R})")
            logits = self._run("step", feeds)[0]          # [S, 1, V]
            nxt_all = torch.argmax(logits[:, 0], dim=-1).tolist()
        except Exception as e:
            # the step writes the arenas in place: a failure leaves them
            # undefined, so every in-flight sequence is lost
            self._arena_lost(f"decode-step failure: {e}")
            return
        now = time.perf_counter()
        self._metrics.observe(self._metrics.step_seconds, now - t0)
        self._metrics.incr("steps")
        for s in active:
            st = self._slots[s]
            self._blocks.note_append(st.blocks[st.cursor // m.block_size])
            nxt = int(nxt_all[s])
            st.generated.append(nxt)
            st.cursor += 1
            st.last_token = nxt
            self._metrics.incr("generated_tokens")
            # finished wins over expired: the device already paid for a
            # COMPLETE generation, deliver it
            if self._finished(st):
                self._retire(s)
            elif st.request.expired(now):
                self._reject_in_flight(st.request, DeadlineExceededError(
                    "deadline expired mid-generation after "
                    f"{len(st.generated)} tokens"), slot=s)

    def _finished(self, st):
        m = self._model
        return (len(st.generated) >= st.request.max_new
                or (m.eos_id is not None and st.last_token == m.eos_id)
                or st.cursor >= m.max_len)

    def _release_slot(self, slot):
        st = self._slots[slot]
        self._slots[slot] = None
        self._pool.release(slot)
        if st is not None and st.blocks:
            self._blocks.release(st.blocks)

    def _retire(self, slot):
        req = self._slots[slot].request
        generated = self._slots[slot].generated
        self._release_slot(slot)
        req.response._complete(outputs={
            "tokens": np.asarray(generated, dtype="int64"),
        })
        self._metrics.incr("completed")

    def _reject_in_flight(self, req, error, slot=None):
        if slot is not None:
            self._release_slot(slot)
        self._reject(req, error)

    # -- reference path ----------------------------------------------------
    def offline_decode(self, prompt, max_new):
        """Offline whole-sequence reference: re-run the full causal
        prefill forward per generated token (no KV cache, no slots, no
        paged-attention kernel) with the same finish rules and greedy
        selection."""
        m = self._model
        toks = list(prompt)
        out = []
        for _ in range(int(max_new)):
            t = len(toks) - 1
            logits = self._run("prefill", self._prefill_feeds(toks))[0]
            nxt = self._choose_token(logits[0, t])
            out.append(nxt)
            toks.append(nxt)
            if m.eos_id is not None and nxt == m.eos_id:
                break
            if len(toks) >= m.max_len:
                break
        return out

    def prefill_logits(self, prompt):
        """``[L, V]`` prefill logits of ``prompt`` (rows past the prompt
        are padding) — the whole-sequence reference's scores."""
        return self._run("prefill", self._prefill_feeds(list(prompt)))[0][0]

    # -- observability ----------------------------------------------------
    def stats(self):
        m = self._model
        snap = self._metrics.snapshot()
        steps = snap.pop("step_seconds")
        prefills = snap.pop("prefill_seconds")
        pool = self._blocks.stats()
        snap.update({
            "model": m.name, "version": m.version,
            "slots": m.slots, "max_len": m.max_len,
            "block_size": m.block_size, "num_blocks": m.num_blocks,
            "active_slots": self._pool.active_count,
            "pending_admissions": len(self._pending),
            "queue": self._queue.stats(),
            "arena_mib": m.arena_bytes() / 2**20,
            "block_pool": pool,
            "block_dedup_ratio": pool["dedup_ratio"],
            "prefix_cache_entries": len(self._prefix),
            "prefix_hits": self._prefix.hits,
            "prefix_misses": self._prefix.misses,
            "step_seconds": steps,
            "prefill_seconds": prefills,
        })
        return snap

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
    def block_pool(self):
        return self._blocks


class GenerationEngine:
    """Front door over N hosted decode models.

    ``place`` defaults to ``CUDAPlace(0)`` and raises without a card;
    pass ``CPUPlace()`` to run on the CPU. ``seed`` seeds the
    ``torch.Generator`` the startup programs draw weights from."""

    _SEQ = 0

    def __init__(self, place=None, queue_depth=256, prefix_cache_size=64,
                 seed=0, label=None):
        self.place = default_place(place)
        self.device = self.place.device
        self.seed = int(seed)
        GenerationEngine._SEQ += 1
        self.label = label or f"genengine-{GenerationEngine._SEQ}"
        self._queue_depth = int(queue_depth)
        self._prefix_cache_size = prefix_cache_size
        self._entries = {}        # (name, version) -> _ModelEntry
        self._latest = {}         # name -> version (last registered)
        self._started = False
        self._next_id = 0
        self._id_lock = threading.Lock()

    # -- model registry ---------------------------------------------------
    def register_model(self, model):
        """Host one (model, version): run its startup program into a
        fresh scope on the engine's place. Returns the entry."""
        if not isinstance(model, DecodeModel):
            model = model()        # zero-arg builder
        if model.key in self._entries:
            raise ValueError(f"model {model.label} already registered")
        if model.chunk_tokens:
            raise NotImplementedError(
                "chunked prefill is not ported yet (ROADMAP.md, M3b)")
        entry = _ModelEntry(self, model, self._queue_depth,
                            self._prefix_cache_size).build()
        self._entries[model.key] = entry
        self._latest[model.name] = model.version
        if self._started:
            entry.start()
        return entry

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
    def submit(self, prompt_ids, model=None, version=None,
               priority=Priority.NORMAL, max_new_tokens=16,
               deadline_ms=None, **options):
        """Admit one greedy generation request; returns its Response
        future (``result()`` -> ``{"tokens": int64 array}``). Raises
        RejectedError on invalid prompts or a full queue, and
        NotImplementedError for a generation mode not ported yet."""
        for opt in options:
            if opt not in _NOT_PORTED:
                raise TypeError(f"submit() got an unexpected keyword "
                                f"argument {opt!r}")
            raise NotImplementedError(
                f"submit({opt}=...) is not ported yet: ROADMAP.md, "
                f"{_NOT_PORTED[opt]}")
        entry = self._resolve(model, version)
        entry.metrics.incr("submitted")
        self._validate(entry, prompt_ids, max_new_tokens, priority)
        deadline = (time.perf_counter() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        with self._id_lock:
            self._next_id += 1
            rid = self._next_id
        req = GenerationRequest(rid, prompt_ids, max_new_tokens, priority,
                                deadline)
        try:
            with entry._cond:
                entry._queue.put(req)
                entry._cond.notify()
        except RejectedError:
            entry.metrics.incr("rejected")
            raise
        return req.response

    @staticmethod
    def _validate(entry, prompt_ids, max_new, priority):
        m = entry.model

        def bad(msg):
            entry.metrics.incr("rejected")
            raise RejectedError(msg)

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
        return {
            "models": {e.model.label: e.stats()
                       for e in self._entries.values()},
            "hosted": ["@".join(k) for k in sorted(self._entries)],
            "place": repr(self.place),
        }
