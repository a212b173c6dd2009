"""Decode-engine metrics: the serving counter set + iteration-level series.

The port's copy of the JAX package's ``serving/decode/metrics.py``:
ServingMetrics (same engine-label discipline, same registry, same
per-tenant counters) plus the quantities that only exist under
iteration-level scheduling — decode steps, active slot-steps (the
occupancy numerator), generated tokens, prefill runs, retirements, and
step/prefill/chunk latency histograms. ``occupancy()`` is the mean
fraction of the S-slot batch doing real work per step.

The port adds the raw host-clock samples behind those histograms, and
more (speculative verify forwards, a beam group's selection rule, the
DEC_MASK feed of a constrained step, each park's spill and each resume
from the host tier, with their bytes), as lists in ``snapshot()``
(``SAMPLES``): the card's measurements take their percentiles exactly.
"""

import threading

from paddle_tpu_torch.serving.metrics import ServingMetrics

__all__ = ["DecodeMetrics"]


class DecodeMetrics(ServingMetrics):
    COUNTERS = ServingMetrics.COUNTERS + (
        # iteration-level scheduler ("generated_tokens" counts tokens a
        # decode STEP produced; each admission's prefill-derived first
        # token is "prefill_tokens" — delivered total is their sum)
        "decode_steps", "active_slot_steps", "generated_tokens",
        "prefill_tokens", "retired", "step_failures",
        # admission / KV pool (prefix hit/miss totals live on
        # PrefixCache itself; only the per-tenant prefix_hits series is
        # a counter)
        "prefills", "rejected_quota", "blocks_exhausted",
        # chunked prefill (one budgeted chunk per engine iteration)
        "chunk_runs", "chunk_tokens",
        # speculative decoding: target verify forwards vs emitted tokens
        # is the headline ratio; accepted/proposed is the acceptance rate
        "spec_target_steps", "spec_draft_steps", "spec_proposed_tokens",
        "spec_accepted_tokens", "spec_emitted_tokens",
        # draft-KV speculative slots; fallbacks count reversion to
        # whole-prompt replay proposals
        "spec_draft_kv_steps", "spec_draft_kv_prefills",
        "spec_draft_kv_fallbacks",
        # generation modes: committed-stream sampling, grammar mask
        # steps, and beam lifecycle events
        "sampled_tokens", "grammar_steps", "beam_requests", "beam_forks",
        "beam_prunes", "beam_finished",
        # circuit breaker relaunch
        "relaunches",
        # overload: arena exhaustion splits into park-with-retry (session
        # spilled to the host tier, resumed byte-identically later) vs
        # loud failure (host tier exhausted or the request can never
        # fit); "blocks_exhausted" stays the umbrella total of both
        "blocks_parked_total", "blocks_failed_total",
        "sessions_parked", "sessions_resumed", "resume_replays",
        "tier_hits", "admissions_deferred",
        # brownout ladder (serving/brownout.py): witnessed transitions
        # and L4/L3 sheds
        "brownout_transitions", "brownout_shed",
    )
    # host-clock samples (seconds; bytes for the *_bytes lists) kept
    # whole beside the histograms
    SAMPLES = ("step_seconds", "prefill_seconds", "chunk_seconds",
               "verify_seconds", "beam_rank_seconds", "mask_seconds",
               "spill_seconds", "spill_bytes", "resume_seconds",
               "resume_bytes")

    def __init__(self, engine_label=None, registry=None):
        super().__init__(engine_label=engine_label, registry=registry)
        labels = {"engine": self.engine_label}
        self._step = self._registry.histogram(
            "serving_decode_step_seconds",
            "one decode iteration (all slots)", labels=labels,
        )
        self._prefill = self._registry.histogram(
            "serving_prefill_seconds",
            "prompt prefill forward latency", labels=labels,
        )
        self._chunk = self._registry.histogram(
            "serving_chunk_prefill_seconds",
            "one budgeted chunk-prefill forward", labels=labels,
        )
        for h in (self._step, self._prefill, self._chunk):
            h.reset()
        self._samples_lock = threading.Lock()
        self._samples = {name: [] for name in self.SAMPLES}

    def observe(self, samples, value):
        """Append one sample to the ``samples`` list."""
        with self._samples_lock:
            self._samples[samples].append(value)

    def observe_step(self, active_slots, new_tokens, seconds):
        self.incr("decode_steps")
        self.incr("active_slot_steps", active_slots)
        self.incr("generated_tokens", new_tokens)
        self._step.observe(seconds)
        self.observe("step_seconds", seconds)

    def observe_prefill(self, seconds, samples="prefill_seconds"):
        """A prefill forward: a whole prompt's, or (``samples=
        "verify_seconds"``) a speculative verify's, which the JAX
        engine's histogram counts as a prefill too."""
        self.incr("prefills")
        self._prefill.observe(seconds)
        self.observe(samples, seconds)

    def observe_chunk(self, tokens, seconds):
        self.incr("chunk_runs")
        self.incr("chunk_tokens", tokens)
        self._chunk.observe(seconds)
        self.observe("chunk_seconds", seconds)

    def occupancy(self, slots):
        steps = self.count("decode_steps")
        if steps <= 0:
            return 0.0
        return self.count("active_slot_steps") / float(steps * slots)

    def tokens_per_step(self):
        steps = self.count("decode_steps")
        if steps <= 0:
            return 0.0
        return self.count("generated_tokens") / float(steps)

    def snapshot(self, extra=None):
        out = super().snapshot(extra=None)
        out.update(self._step.snapshot("decode_step"))
        out.update(self._prefill.snapshot("prefill"))
        out.update(self._chunk.snapshot("chunk_prefill"))
        with self._samples_lock:
            out.update({k: list(v) for k, v in self._samples.items()})
        if extra:
            out.update(extra)
        return out
