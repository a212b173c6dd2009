"""The PyTorch port's decode engine under overload, against the JAX
package's engine, at a tiny size on the CPU.

Both engines host the same models (weights carried across with
``convert.load_params``) and are hand-stepped through their scheduler
loop bodies on the same requests. Under a block pool that serves about
two sessions:

* in every mode — greedy under each victim policy, sampled, chunked (with
  a later admission restored from the host tier), speculative (replay and
  draft-KV proposals, and a speculative slot parked by hand), beam and
  grammar-constrained — the port gives the JAX engine's tokens and the
  same park, resume, write-back, tier-hit and replay counts, and no
  request fails;
* a parked entry whose bytes were flipped is quarantined and its rows are
  recomputed from the tokens, bit for bit;
* a beam whose forks find no block parks as a group and resumes to the
  offline reference's hypotheses (the JAX engine fails that group);
* a prompt that can never fit fails loudly with the JAX engine's message;
* the brownout ladder's two reject rungs fire only under live pressure.

The host tier and brownout unit cases are the JAX package's own
(``tests/test_overload.py``), run on the port's classes.
"""

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu.serving.brownout import BrownoutController as JaxBrownout
from paddle_tpu.serving.decode import CompiledGrammar as JaxGrammar
from paddle_tpu.serving.decode import GenerationEngine as JaxEngine
from paddle_tpu.serving.decode import SamplingParams as JaxSampling
from paddle_tpu.serving.decode import build_decoder_model as jax_build
from paddle_tpu.serving.decode.tier import HostKVTier as JaxTier
from paddle_tpu.serving.request import RequestError as JaxRequestError
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.serving.brownout import BrownoutController
from paddle_tpu_torch.serving.decode import (
    BeamParams,
    CompiledGrammar,
    GrammarConstraint,
    HostKVTier,
    SamplingParams,
)
from paddle_tpu_torch.serving.decode import GenerationEngine as TorchEngine
from paddle_tpu_torch.serving.decode import build_decoder_model as torch_build
from paddle_tpu_torch.serving.decode.pool import PrefixCache
from paddle_tpu_torch.serving.request import (
    Priority,
    RejectedError,
    RequestError,
)

# "ov": the JAX tests' tight model (tests/test_overload.py _tight_model)
# with four slots and 7 blocks of 2 (a 15-token prompt never fits);
# "ovx": eos 0, the DEC_MASK feed and a chunk budget, 10 blocks of 4 (two
# sessions of 20 tokens); "ovd": its 1-layer draft
OV = dict(vocab_size=32, hidden=8, num_layers=1, slots=4, max_len=16,
          block_size=2, num_blocks=7)
OVX = dict(vocab_size=64, hidden=16, num_layers=2, slots=4, max_len=32,
           block_size=4, num_blocks=10, eos_id=0, logits_mask=True,
           chunk_tokens=5)
OVD = dict(vocab_size=64, hidden=16, num_layers=1, slots=4, max_len=32,
           block_size=4)
VOCAB = (["<eos>"] + list("abcdefghijklmnopqrstuvwxyz")
         + list("ABCDEFGHIJ0123456789") + list('{}[]",:-. _')
         + ["true", "false", "null", '"a"', "ab", '":'])
REGEX = "[A-E][a-z]+( [A-E][a-z]+)*"
SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "tags": {"type": "array", "items": {"enum": ["a", "b"]}}}}
COUNTS = ("sessions_parked", "sessions_resumed", "resume_replays",
          "tier_hits", "failed", "completed", "blocks_failed_total")


def _param_arrays(jentry):
    m = jentry.model
    arenas = {n for kv in m.state_names for n in kv}
    return {v.name: np.asarray(jentry._scope.find_var(v.name))
            for v in m.startup_program.global_block().vars.values()
            if v.persistable and v.name not in arenas}


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine (CPU, both hand-stepped, breakers
    off) hosting the same "ov", "ovx" and "ovd"."""
    jeng = JaxEngine(queue_depth=16, breaker_threshold=0)
    teng = TorchEngine(place=pt.CPUPlace(), queue_depth=16,
                       breaker_threshold=0)
    for name, geom in (("ov", OV), ("ovx", OVX), ("ovd", OVD)):
        jentry = jeng.register_model(jax_build(**geom, name=name))
        tentry = teng.register_model(torch_build(**geom, name=name))
        load_params(tentry.scope, _param_arrays(jentry))
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _fresh(entry, jax_side, tier_mb=64):
    """Zeroed arenas, an empty pool, prefix cache and host tier, and a
    fresh brownout ladder: each test starts both engines from the same
    state."""
    entry._reset_arenas()
    if jax_side:
        entry._prefix.clear()
    else:
        entry._prefix = PrefixCache(64)
    entry._tier = (JaxTier if jax_side else HostKVTier)(
        capacity_bytes=tier_mb << 20)
    entry._blocks.attach_tier(entry._tier, read_rows=entry._read_block_rows)
    entry._brownout = (JaxBrownout if jax_side else BrownoutController)()
    entry._bt_seen = 0
    entry._parked, entry._pending = [], []
    entry._admit_seq = 0
    entry._pref_rr = 0
    entry._chunk_throttle = False
    entry.victim_policy = None


def _drain(entries, resps, hook=None, iters=800):
    for _ in range(iters):
        if all(r.done() for r in resps):
            return
        if hook is not None:
            hook()
        for e in entries:
            e._iterate()
    raise AssertionError("hand-stepped drain did not converge")


def _counts(entry):
    st = entry.stats()
    out = {k: st[k] for k in COUNTS}
    out["tier_writebacks"] = st["block_pool"]["tier_writebacks"]
    return out


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _serve(engine, name, reqs, jax_side, policy=None, hook=None,
           fresh=True):
    """Submit ``reqs`` ((prompt, submit kwargs) pairs) to one engine's
    entry ``name`` in order and hand-step it (and the draft, when one is
    named) until all finish. Returns (token streams or beam lists, count
    deltas)."""
    entry = engine.entry(name)
    if fresh:
        for key in engine.models():
            _fresh(engine._entries[key], jax_side)
    entry.victim_policy = policy
    before = _counts(entry)
    resps = [engine.submit(p, model=name, **kw) for p, kw in reqs]
    _drain([entry], resps, hook=(lambda: hook(entry)) if hook else None)
    outs = []
    for r in resps:
        res = r.result(timeout=60)
        if "beams" in res:
            outs.append([([int(t) for t in b["tokens"]], b["score"])
                         for b in res["beams"]])
        else:
            outs.append([int(t) for t in res["tokens"]])
    entry.block_pool.check_conservation()
    return outs, _delta(_counts(entry), before)


def _both(engines, name, reqs, policy=None, hook=None, jax_reqs=None):
    jeng, teng = engines
    jout, jcnt = _serve(jeng, name, jax_reqs or reqs, True, policy, hook)
    tout, tcnt = _serve(teng, name, reqs, False, policy, hook)
    return tout, tcnt, jout, jcnt


def _same(tout, jout):
    for got, want in zip(tout, jout):
        if got and isinstance(got[0], tuple):       # beams
            assert [t for t, _s in got] == [t for t, _s in want]
            for (_t, a), (_u, b) in zip(got, want):
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (a, b)
        else:
            assert got == want
    assert len(tout) == len(jout)


# ---------------------------------------------------------------------------
# host KV tier (unit)
# ---------------------------------------------------------------------------


def test_host_tier_put_get_lru_and_capacity():
    tier = HostKVTier(capacity_bytes=1024)   # 4 entries of 256 B
    rows = [(np.ones((4, 8), "float32"), np.ones((4, 8), "float32"))]
    assert tier.put("blk:a", rows, 4, tokens=(1, 2, 3, 4))
    assert "blk:a" in tier and len(tier) == 1
    ent = tier.get("blk:a")
    assert ent is not None and ent.size_used == 4
    assert np.array_equal(ent.kv_rows[0][0], rows[0][0])
    # LRU: filling past capacity evicts the stalest entry, never errors
    for i in range(8):
        assert tier.put(f"blk:{i}", rows, 4, tokens=(i,))
    assert "blk:a" not in tier
    assert tier.stats()["evictions"] >= 1
    # an entry that ALONE exceeds the budget is the only refusal
    tiny = HostKVTier(capacity_bytes=8)
    assert not tiny.put("blk:x", rows, 4, tokens=(1,))
    assert tiny.stats()["rejected"] == 1


def test_host_tier_crc_quarantines_corruption():
    tier = HostKVTier(capacity_bytes=1 << 20)
    rows = [(np.arange(32, dtype="float32").reshape(4, 8),
             np.zeros((4, 8), "float32"))]
    tier.put("park:7:0", rows, 4, tokens=(1, 2, 3, 4))
    assert tier.stats()["spills"] == 1       # park: keys count as spills
    # the CRC is JAX's: zlib's CRC32 over the same row bytes
    jtier = JaxTier(capacity_bytes=1 << 20)
    jtier.put("park:7:0", rows, 4, tokens=(1, 2, 3, 4))
    assert tier._entries["park:7:0"].crc == jtier._entries["park:7:0"].crc
    tier.corrupt_entry("park:7:0")
    # a corrupt entry reads as a MISS, never as wrong bytes
    assert tier.pop("park:7:0") is None
    st = tier.stats()
    assert st["corrupt_dropped"] == 1 and st["misses"] == 1
    assert "park:7:0" not in tier


# ---------------------------------------------------------------------------
# brownout controller (unit, hand-stepped, no threads)
# ---------------------------------------------------------------------------


def _escalates_immediately(ctl):
    assert ctl.step(occupancy=0.2) == 0
    assert ctl.step(occupancy=0.97) == 4     # straight to L4, no ladder
    (t,) = ctl.transitions
    assert t["from"] == 0 and t["to"] == 4
    assert t["trigger"] == "occupancy" and t["value"] == 0.97


def _deescalates_one_level_per_hold(ctl):
    ctl.step(occupancy=0.97)
    for expect in (4, 4, 3):                 # 3 clear steps -> one level
        assert ctl.step(occupancy=0.1) == expect
    for expect in (3, 3, 2):
        assert ctl.step(occupancy=0.1) == expect


def _hysteresis_band_holds(ctl):
    ctl.step(occupancy=0.9)                  # -> L3
    assert ctl.level == 3
    for _ in range(10):                      # inside the band: no motion
        assert ctl.step(occupancy=0.75) == 3
    assert len(ctl.transitions) == 1


def _clear_streak_resets_on_blip(ctl):
    ctl.step(occupancy=0.97)
    ctl.step(occupancy=0.1)
    ctl.step(occupancy=0.1)
    ctl.step(occupancy=0.9)                  # blip: streak must reset
    for expect in (4, 4, 3):
        assert ctl.step(occupancy=0.1) == expect


def _trigger_names_the_binding_signal(ctl):
    ctl.step(occupancy=0.3, queue_seconds=0.96, deadline=0.5)
    assert ctl.transitions[-1]["trigger"] == "queue_seconds"


BROWNOUT_CASES = {
    "escalates_immediately_to_highest_rung": _escalates_immediately,
    "deescalates_one_level_per_hold_window": _deescalates_one_level_per_hold,
    "hysteresis_band_holds_without_flapping": _hysteresis_band_holds,
    "clear_streak_resets_on_pressure_blip": _clear_streak_resets_on_blip,
    "trigger_names_the_binding_signal": _trigger_names_the_binding_signal,
}


@pytest.mark.parametrize("case", sorted(BROWNOUT_CASES))
def test_brownout_ladder(case):
    """Each JAX case on the port's controller, and the two controllers
    record the same transitions."""
    ctl, jctl = BrownoutController(hold=3), JaxBrownout(hold=3)
    BROWNOUT_CASES[case](ctl)
    BROWNOUT_CASES[case](jctl)
    assert ctl.snapshot() == jctl.snapshot()


# ---------------------------------------------------------------------------
# park / resume against the JAX engine
# ---------------------------------------------------------------------------


def _oldest(entry):
    return lambda cands: min(cands, key=lambda s: entry._slots[s].seq)


def _shuffled(entry):
    return lambda cands: sorted(
        cands, key=lambda s: (entry._slots[s].seq * 2654435761) % 97)[0]


POLICIES = {"default": None, "oldest": _oldest, "shuffled": _shuffled}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_greedy_parks_and_resumes_as_the_jax_engine_any_victim(engines,
                                                               policy):
    """Three 4-token prompts fill 6 of 7 blocks; a fourth arrives needing
    2, so a victim chosen by the policy parks (its rows go to the host
    tier) and later appends park again. Every stream equals
    the JAX engine's (and its offline reference), with the same counts,
    and nothing fails."""
    jeng, teng = engines
    prompts = [[1 + i, 2 + i, 3 + i, 4 + i] for i in range(3)]
    prompts.append([9, 8, 7, 6])
    reqs = [(p, dict(max_new_tokens=6)) for p in prompts]
    calls = []

    def make(side):
        def pol(cands):
            entry = (jeng if side == "jax" else teng).entry("ov")
            calls.append(side)
            return POLICIES[policy](entry)(cands)
        return pol if POLICIES[policy] else None

    jout, jcnt = _serve(jeng, "ov", reqs, True, make("jax"))
    tout, tcnt = _serve(teng, "ov", reqs, False, make("torch"))
    refs = [teng.entry("ov").offline_decode(p, 6) for p in prompts]
    assert tout == jout == refs
    assert tcnt == jcnt
    assert tcnt["sessions_parked"] >= 2 and tcnt["failed"] == 0
    assert tcnt["sessions_parked"] == tcnt["sessions_resumed"]
    if POLICIES[policy]:
        assert calls.count("torch") == calls.count("jax") >= 1


def test_sampled_streams_park_and_resume_as_the_jax_engine(engines):
    """A park/resume in the middle of a committed threefry stream moves no
    draw: the sampled streams equal the JAX engine's."""
    reqs = [([1, 2, 3, 4], 7), ([5, 6, 7, 8], 8), ([9, 10, 11, 12], 6)]
    tout, tcnt, jout, jcnt = _both(
        engines, "ov",
        [(p, dict(max_new_tokens=n, sampling=SamplingParams(
            temperature=0.8, top_k=6, seed=11 + n))) for p, n in reqs],
        jax_reqs=[(p, dict(max_new_tokens=n, sampling=JaxSampling(
            temperature=0.8, top_k=6, seed=11 + n))) for p, n in reqs])
    assert tout == jout
    assert tcnt == jcnt and tcnt["sessions_parked"] >= 1
    assert tcnt["failed"] == 0


def test_corruption_walkback_recomputes_bit_identical(engines):
    """Flip a byte of the first parked session's tier entry: the CRC
    quarantines it, the resume recomputes the rows from the committed
    tokens (``resume_replays``) — on this model the same bits as the
    spilled rows — and the streams stay the JAX engine's, whose tier is
    corrupted at the same moment."""
    seen = {}
    walked = []
    tentry = engines[1].entry("ov")
    orig = tentry._inject_rows

    def corrupt(entry):
        if entry._parked and id(entry) not in seen:
            keys = entry._parked[0].keys
            if entry is tentry:
                seen["rows"] = [(k.copy(), v.copy()) for k, v in
                                entry._tier._entries[keys[0]].kv_rows]
                seen["key"] = keys[0]
            seen[id(entry)] = [entry._tier.corrupt_entry(k) for k in keys]

    def inject(st, key):
        ok = orig(st, key)
        if key == seen.get("key") and not walked:
            walked.append(tentry._read_rows(st.row_map, st.cursor))
        return ok

    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [2, 4, 6, 8]]
    tentry._inject_rows = inject
    try:
        tout, tcnt, jout, jcnt = _both(
            engines, "ov", [(p, dict(max_new_tokens=6)) for p in prompts],
            hook=corrupt)
    finally:
        del tentry._inject_rows
    assert all(all(seen[id(e)]) for e in (
        engines[0].entry("ov"), tentry))
    assert tout == jout
    assert tcnt == jcnt
    assert tcnt["resume_replays"] >= 1 and tcnt["failed"] == 0
    assert tentry.stats()["host_tier"]["corrupt_dropped"] >= 1
    (back,) = walked
    for (k, v), (k2, v2) in zip(seen["rows"], back):
        assert np.array_equal(k.view(np.uint32), k2.view(np.uint32))
        assert np.array_equal(v.view(np.uint32), v2.view(np.uint32))


def test_chunked_admission_restores_from_the_tier_as_the_jax_engine(
        engines):
    """A 16-token prompt streams through the chunk program (4 full
    blocks, registered); other traffic then evicts its cached blocks,
    writing them back to the host tier; the same prompt again re-injects
    them from the tier instead of chunking them (``tier_hits``). Tokens
    and counts equal the JAX engine's."""
    rng = np.random.RandomState(3)
    long = rng.randint(1, 64, 16).tolist()
    first = [(long, dict(max_new_tokens=3))]
    churn = [(rng.randint(1, 64, 6).tolist(), dict(max_new_tokens=10))
             for _ in range(4)]
    again = [(long + [5], dict(max_new_tokens=4))]
    jeng, teng = engines
    outs = {}
    for side, eng in (("jax", jeng), ("torch", teng)):
        o1, c1 = _serve(eng, "ovx", first, side == "jax")
        o2, c2 = _serve(eng, "ovx", churn, side == "jax", fresh=False)
        o3, c3 = _serve(eng, "ovx", again, side == "jax", fresh=False)
        outs[side] = (o1 + o2 + o3, [c1, c2, c3])
    assert outs["torch"][0] == outs["jax"][0]
    assert outs["torch"][1] == outs["jax"][1]
    c1, c2, c3 = outs["torch"][1]
    assert c2["tier_writebacks"] >= 1 and c3["tier_hits"] >= 1
    assert c2["sessions_parked"] >= 1
    assert sum(c["failed"] for c in outs["torch"][1]) == 0
    tentry = teng.entry("ovx")
    assert outs["torch"][0][-1] == tentry.offline_decode(long + [5], 4)


@pytest.mark.parametrize("draft_kv", [False, True])
def test_speculative_requests_under_pressure_match_the_jax_engine(engines,
                                                                  draft_kv):
    """Speculative requests (replay or draft-KV proposals from "ovd")
    beside decode requests that park: every stream equals the JAX
    engine's, with the same counts."""
    rng = np.random.RandomState(5)
    reqs = []
    for i in range(4):
        kw = dict(max_new_tokens=int(rng.randint(12, 16)))
        if i % 2 == 0:
            kw.update(draft_model="ovd", spec_k=3, draft_kv=draft_kv)
        reqs.append((rng.randint(1, 64, int(rng.randint(9, 13))).tolist(),
                     kw))
    tout, tcnt, jout, jcnt = _both(engines, "ovx", reqs)
    assert tout == jout
    assert tcnt == jcnt and tcnt["failed"] == 0
    assert tcnt["sessions_parked"] >= 1
    tentry = engines[1].entry("ovx")
    for (p, kw), got in zip(reqs, tout):
        assert got == tentry.offline_decode(p, kw["max_new_tokens"])
    if draft_kv:
        assert tentry.stats()["spec_draft_kv_steps"] > 0


def test_a_parked_speculative_slot_resumes_on_replay_proposals(engines):
    """A speculative slot parked by hand (``_park_slot``) keeps no target
    rows: its draft-KV footprint is released, and it resumes proposing by
    replay with the same committed tokens, as the JAX engine does."""
    jeng, teng = engines
    prompt, n = [7, 3, 9, 12, 5, 30], 10
    outs, cnts = {}, {}
    for side, eng in (("jax", jeng), ("torch", teng)):
        for key in eng.models():
            _fresh(eng._entries[key], side == "jax")
        entry = eng.entry("ovx")
        before = _counts(entry)
        r = eng.submit(prompt, model="ovx", max_new_tokens=n,
                       draft_model="ovd", spec_k=3)
        entry._iterate()
        entry._iterate()
        (s,) = [i for i, st in enumerate(entry._slots) if st is not None]
        assert entry._slots[s].mode == "spec"
        assert entry._slots[s].d_slot is not None       # draft-KV
        assert entry._park_slot(s)
        assert entry._slots[s] is None
        _drain([entry], [r])
        outs[side] = [int(t) for t in r.result(timeout=60)["tokens"]]
        cnts[side] = _delta(_counts(entry), before)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"] == teng.entry("ovx").offline_decode(prompt, n)
    assert cnts["torch"] == cnts["jax"]
    assert cnts["torch"]["sessions_parked"] == 1
    assert cnts["torch"]["sessions_resumed"] == 1
    assert teng.entry("ovx").stats()["spec_draft_steps"] > 0   # replay


def test_beam_groups_park_and_resume_as_the_jax_engine(engines):
    """Two width-2 beams on 10 blocks: a group that finds no block for
    its next append parks whole (every hypothesis rank-keyed) and resumes
    in rank order. Hypotheses, scores and counts equal the JAX engine's
    and the offline reference's."""
    reqs = [([4, 9, 17, 3, 22, 8], dict(max_new_tokens=12, beam_width=2)),
            ([11, 5, 28, 14, 2], dict(max_new_tokens=11, beam_width=2))]
    tout, tcnt, jout, jcnt = _both(engines, "ovx", reqs)
    _same(tout, jout)
    assert tcnt == jcnt and tcnt["failed"] == 0
    assert tcnt["sessions_parked"] >= 1
    assert tcnt["sessions_parked"] == tcnt["sessions_resumed"]
    tentry = engines[1].entry("ovx")
    for (p, kw), got in zip(reqs[:2], tout):
        want = tentry.offline_beam(p, kw["max_new_tokens"],
                                   BeamParams(kw["beam_width"]))
        _same([got], [[(list(t), s) for t, s in want]])


@pytest.mark.parametrize("kind", ["regex", "schema"])
def test_constrained_streams_park_and_resume_as_the_jax_engine(engines,
                                                               kind):
    """Grammar-constrained streams (the state masks ride the DEC_MASK
    feed; the grammar cursor travels with the parked slot) under the same
    pressure: tokens and counts equal the JAX engine's, and each stream
    walks its grammar."""
    make = {"regex": lambda cls: cls.from_regex(REGEX, VOCAB, 0),
            "schema": lambda cls: cls.from_json_schema(SCHEMA, VOCAB, 0)}
    pg, jg = make[kind](CompiledGrammar), make[kind](JaxGrammar)
    prompts = [[3, 9, 27, 1, 5], [40, 7, 2, 2, 8, 13], [6, 6, 1, 30]]
    tout, tcnt, jout, jcnt = _both(
        engines, "ovx",
        [(p, dict(max_new_tokens=14, grammar=pg)) for p in prompts]
        + [([12, 14, 16, 18], dict(max_new_tokens=14))],
        jax_reqs=[(p, dict(max_new_tokens=14, grammar=jg)) for p in prompts]
        + [([12, 14, 16, 18], dict(max_new_tokens=14))])
    assert tout == jout
    assert tcnt == jcnt and tcnt["failed"] == 0
    assert tcnt["sessions_parked"] >= 1
    for toks in tout[:3]:
        c = GrammarConstraint(pg)
        for t in toks:
            c.advance(t)             # raises on a banned token


def test_a_beam_whose_forks_find_no_block_parks_as_a_group(engines):
    """One width-3 beam on a pool of 10 blocks, 7 of them held by a
    decode request: its first selection forks two hypotheses from a
    prompt whose last block is partial, so each fork needs a block. With
    one free, the group parks in its post-selection state (forks spilled
    with their parent's rows) and resumes once blocks free, to the
    offline reference's hypotheses. (The JAX engine fails such a
    group.)"""
    jeng, teng = engines
    entry = teng.entry("ovx")
    _fresh(entry, False)
    hog = teng.submit(list(range(1, 26)), model="ovx", max_new_tokens=6)
    entry._iterate()
    prompt = [8, 1, 33, 2, 9]
    r = teng.submit(prompt, model="ovx", max_new_tokens=5, beam_width=3)
    before = _counts(entry)
    _drain([entry], [hog, r])
    got = [([int(t) for t in b["tokens"]], b["score"])
           for b in r.result(timeout=60)["beams"]]
    want = entry.offline_beam(prompt, 5, BeamParams(3))
    _same([got], [[(list(t), s) for t, s in want]])
    cnt = _delta(_counts(entry), before)
    assert cnt["sessions_parked"] >= 1 and cnt["failed"] == 0
    assert cnt["sessions_parked"] == cnt["sessions_resumed"]
    entry.block_pool.check_conservation()


def test_never_fit_prompt_fails_loudly_with_the_jax_message(engines):
    """The one hard failure: a prompt whose blocks exceed the whole pool
    fails at admission, attributed, with the JAX engine's message."""
    jeng, teng = engines
    msgs = []
    for side, eng, err in (("jax", jeng, JaxRequestError),
                           ("torch", teng, RequestError)):
        entry = eng.entry("ov")
        _fresh(entry, side == "jax")
        before = entry.metrics.count("blocks_failed_total")
        with pytest.raises(err, match="can never fit") as exc:
            r = eng.submit(list(range(1, 16)), model="ov", max_new_tokens=1)
            _drain([entry], [r])
            r.result(timeout=60)
        msgs.append(str(exc.value).split(": ", 1)[1])
        assert entry.metrics.count("blocks_failed_total") == before + 1
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the two REJECT rungs: stale severity must not shed
# ---------------------------------------------------------------------------


def test_l4_shed_requires_live_pressure(engines):
    _jeng, teng = engines
    entry = teng.entry("ov")
    _fresh(entry, False)
    entry._brownout.level = 4
    # severity says shed, but the engine is idle: admission must pass
    r = teng.submit([1, 2], model="ov", max_new_tokens=2)
    _drain([entry], [r])
    assert len(r.result(timeout=60)["tokens"]) == 2
    # now live pressure confirms it: non-HIGH is turned away with a
    # measured retry-after, HIGH still lands
    shed0 = entry.metrics.count("brownout_shed")
    entry._pending.append(object())
    try:
        with pytest.raises(RejectedError) as exc:
            teng.submit([1, 2], model="ov", max_new_tokens=2)
        assert exc.value.retry_after_s > 0.0
        assert entry.metrics.count("brownout_shed") == shed0 + 1
        high = teng.submit([1, 2], model="ov", max_new_tokens=2,
                           priority=Priority.HIGH)
    finally:
        entry._pending.pop()
    entry._brownout.level = 0
    _drain([entry], [high])
    assert len(high.result(timeout=60)["tokens"]) == 2


def test_l3_beam_cap_requires_live_pressure(engines):
    _jeng, teng = engines
    entry = teng.entry("ovx")
    _fresh(entry, False)
    entry._brownout.level = 3
    # idle engine: a wide beam admits despite the stale severity
    r = teng.submit([1, 2], model="ovx", max_new_tokens=2, beam_width=3)
    _drain([entry], [r])
    assert r.result(timeout=60)["beams"]
    entry._pending.append(object())
    try:
        with pytest.raises(RejectedError, match="beam width capped"):
            teng.submit([1, 2], model="ovx", max_new_tokens=2, beam_width=3)
        # at or under the cap still admits
        ok = teng.submit([1, 2], model="ovx", max_new_tokens=2,
                         beam_width=2)
    finally:
        entry._pending.pop()
    entry._brownout.level = 0
    _drain([entry], [ok])
    assert ok.result(timeout=60)["beams"]


# ---------------------------------------------------------------------------
# the radix index after an interior block's eviction
# ---------------------------------------------------------------------------


def test_radix_chain_breaks_at_an_evicted_interior_block():
    """LRU eviction can recycle a chain's FIRST block while a later one
    stays registered (it was released later). The port's radix then
    breaks the chain at the evicted node: the prompt maps to fresh
    blocks, and re-registering it names the node again. The JAX pool
    (the same tree) hands out the evicted node's missing block id, and
    the admission fails with a TypeError."""
    from paddle_tpu.serving.decode.pool import BlockPool as JaxPool
    from paddle_tpu_torch.serving.decode.pool import BlockPool

    prompt = [1, 2, 3, 4]          # two full blocks of 2
    for cls in (BlockPool, JaxPool):
        pool = cls(num_blocks=3, block_size=2)
        blocks, _ = pool.acquire_for_prompt(prompt)
        pool.register_prompt_blocks(blocks, prompt)
        pool.release(blocks[:1])   # the first block is the older cached
        pool.release(blocks[1:])
        other, _ = pool.acquire_for_prompt([9, 9])   # takes the free one
        more, _ = pool.acquire_for_prompt([8, 8])    # evicts block 0
        assert other is not None and more is not None
        pool.release(other + more)
        if cls is JaxPool:
            with pytest.raises(TypeError):
                pool.acquire_for_prompt(prompt)
            continue
        again, shared = pool.acquire_for_prompt(prompt)
        assert again is not None and shared == 0
        pool.register_prompt_blocks(again, prompt)
        pool.release(again)
        pool.check_conservation()
        # the chain is whole again: the new first block, then the old
        # second one (still cached, the rows of the same prefix)
        hit, shared = pool.acquire_for_prompt(prompt)
        assert shared == 4 and hit[0].id == again[0].id
