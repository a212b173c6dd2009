"""Grammar-constrained decode: regex / JSON-schema -> per-step logits
masks, compiled on the host, fed as data.

The port's copy of the JAX package's
``serving/decode/generate/grammar.py``: the same parser, automata and
float32 masks, with ``NEG_INF`` from the port's own ``model.py``.

The constraint has to keep the engine's fixed program shapes and its
exact replay. Both follow from compiling the grammar to a token-level
mask function on the host and feeding the result through one
fixed-shape ``[S, 1, V]`` additive feed (``model.py``'s ``DEC_MASK``);
logits that come from a prefill are masked with the same float32 add on
the host: IEEE ``x + 0.0 == x`` and the ``-1e9`` padding contract make
the two places give the same bytes.

* regex (a practical subset: literals, escapes, ``.``, ``[...]``
  classes with ranges/negation, grouping, ``|``, ``* + ?``) compiles
  through a Thompson NFA to a subset-construction DFA over exactly the
  characters the vocabulary can emit;
* DFA states that cannot reach an accepting state are pruned as DEAD,
  so a live state always has at least one allowed continuation: a
  constrained generation can never paint itself into a corner;
* a token is allowed in state ``s`` iff walking its string lands in a
  live state; EOS is allowed exactly in accepting states (which is why
  grammar requests need a model with an ``eos_id``);
* per-state ``[V]`` masks are computed lazily and cached on the
  COMPILED grammar (shared by every request and every beam using it);
  the per-request or per-beam cursor is ONE integer, which is what makes
  grammar state free to fork in beam search.

JSON-schema support is a canonical-form subset (objects with declared
properties in order, no whitespace; string/integer/number/boolean/null
/enum/array leaves) lowered to a regex and compiled through the same
automaton: one mask semantics.
"""

import numpy as np

from paddle_tpu_torch.serving.decode.model import NEG_INF

__all__ = ["CompiledGrammar", "GrammarConstraint", "compile_regex",
           "json_schema_regex"]


# -- regex -> NFA (Thompson construction) --------------------------------

_CLASSES = {
    "d": set("0123456789"),
    "w": set("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": set(" \t\n\r"),
}


class _Frag:
    __slots__ = ("start", "accepts")

    def __init__(self, start, accepts):
        self.start = start
        self.accepts = accepts


class _NFA:
    def __init__(self):
        self.eps = []        # state -> [state]
        self.trans = []      # state -> [(frozenset(chars) | None=any, state)]

    def new_state(self):
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1


class _RegexParser:
    """Recursive-descent regex -> NFA fragment. Grammar:
    alt := concat ('|' concat)* ; concat := repeat* ;
    repeat := atom ('*'|'+'|'?')? ; atom := literal | class | '.' | '(' alt ')'
    """

    def __init__(self, pattern, nfa):
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self):
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        frag = self._alt()
        if self.i != len(self.p):
            raise ValueError(
                f"unexpected {self.p[self.i]!r} at {self.i} in regex "
                f"{self.p!r}")
        return frag

    def _alt(self):
        frags = [self._concat()]
        while self._peek() == "|":
            self._take()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        start = self.nfa.new_state()
        accepts = []
        for f in frags:
            self.nfa.eps[start].append(f.start)
            accepts.extend(f.accepts)
        return _Frag(start, accepts)

    def _concat(self):
        frags = []
        while self._peek() is not None and self._peek() not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self.nfa.new_state()
            return _Frag(s, [s])
        out = frags[0]
        for f in frags[1:]:
            for a in out.accepts:
                self.nfa.eps[a].append(f.start)
            out = _Frag(out.start, f.accepts)
        return out

    def _repeat(self):
        frag = self._atom()
        c = self._peek()
        if c not in ("*", "+", "?"):
            return frag
        self._take()
        start = self.nfa.new_state()
        end = self.nfa.new_state()
        self.nfa.eps[start].append(frag.start)
        for a in frag.accepts:
            self.nfa.eps[a].append(end)
        if c in ("*", "?"):
            self.nfa.eps[start].append(end)      # skip
        if c in ("*", "+"):
            self.nfa.eps[end].append(frag.start)  # loop
        return _Frag(start, [end])

    def _atom(self):
        c = self._take()
        if c == "(":
            frag = self._alt()
            if self._peek() != ")":
                raise ValueError(f"unbalanced '(' in regex {self.p!r}")
            self._take()
            return frag
        if c == "[":
            return self._char_frag(self._char_class())
        if c == ".":
            return self._char_frag(None)          # any char
        if c == "\\":
            return self._char_frag(self._escape(self._take()))
        if c in "*+?)|":
            raise ValueError(f"unexpected {c!r} in regex {self.p!r}")
        return self._char_frag(frozenset(c))

    def _escape(self, c):
        if c in _CLASSES:
            return frozenset(_CLASSES[c])
        if c == "n":
            return frozenset("\n")
        if c == "t":
            return frozenset("\t")
        return frozenset(c)                       # \. \\ \[ \" ...

    def _char_class(self):
        negate = False
        if self._peek() == "^":
            self._take()
            negate = True
        chars = set()
        while True:
            c = self._peek()
            if c is None:
                raise ValueError(f"unbalanced '[' in regex {self.p!r}")
            if c == "]":
                self._take()
                break
            c = self._take()
            if c == "\\":
                chars |= set(self._escape(self._take()))
                continue
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self._take()
                hi = self._take()
                chars |= {chr(x) for x in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        if negate:
            return ("negate", frozenset(chars))
        return frozenset(chars)

    def _char_frag(self, charset):
        start = self.nfa.new_state()
        end = self.nfa.new_state()
        self.nfa.trans[start].append((charset, end))
        return _Frag(start, [end])


def _charset_match(charset, ch):
    if charset is None:                           # '.'
        return True
    if isinstance(charset, tuple):                # ("negate", chars)
        return ch not in charset[1]
    return ch in charset


class _DFA:
    """Deterministic automaton with dead states pruned: ``step`` returns
    the next LIVE state or None; ``accepting`` is per-state."""

    __slots__ = ("start", "table", "accepting")

    def __init__(self, start, table, accepting):
        self.start = start
        self.table = table            # state -> {char: state}
        self.accepting = accepting    # list[bool]

    def step(self, state, ch):
        return self.table[state].get(ch)

    def walk(self, state, text):
        for ch in text:
            state = self.table[state].get(ch)
            if state is None:
                return None
        return state


def compile_regex(pattern, alphabet):
    """Compile ``pattern`` to a dead-state-free DFA over ``alphabet``
    (the set of characters the vocabulary can emit — characters outside
    it can never be generated, so the DFA doesn't need them)."""
    nfa = _NFA()
    frag = _RegexParser(str(pattern), nfa).parse()
    accept_set = frozenset(frag.accepts)
    alphabet = sorted(set(alphabet))

    def eps_closure(states):
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start = eps_closure({frag.start})
    index = {start: 0}
    order = [start]
    table = []
    queue = [start]
    while queue:
        cur = queue.pop(0)
        row = {}
        for ch in alphabet:
            nxt = set()
            for s in cur:
                for charset, t in nfa.trans[s]:
                    if _charset_match(charset, ch):
                        nxt.add(t)
            if not nxt:
                continue
            closed = eps_closure(nxt)
            if closed not in index:
                index[closed] = len(order)
                order.append(closed)
                queue.append(closed)
                table.append(None)   # placeholder; filled when popped
            row[ch] = index[closed]
        if len(table) <= index[cur]:
            table.extend([None] * (index[cur] + 1 - len(table)))
        table[index[cur]] = row
    accepting = [bool(st & accept_set) for st in order]
    # prune DEAD states (cannot reach an accepting state): reverse BFS
    n = len(order)
    rev = [[] for _ in range(n)]
    for s, row in enumerate(table):
        for t in row.values():
            rev[t].append(s)
    live = set(i for i in range(n) if accepting[i])
    stack = list(live)
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise ValueError(
            f"regex {pattern!r} matches nothing over this vocabulary")
    pruned = [{ch: t for ch, t in row.items() if t in live}
              for row in table]
    return _DFA(0, pruned, accepting)


# -- JSON schema (canonical-form subset) -> regex ------------------------

_JSON_STRING = '"[a-zA-Z0-9_ ]*"'
_JSON_INT = "(-?(0|[1-9][0-9]*))"
_JSON_NUM = _JSON_INT + "(\\.[0-9][0-9]*)?"
_JSON_BOOL = "(true|false)"


def json_schema_regex(schema):
    """Lower a JSON-schema subset to a regex over the CANONICAL encoding
    (properties in declared order, all present, no whitespace). Supports
    type string/integer/number/boolean/null, enum (of strings), array
    (homogeneous items), object (nested). Canonical form is the honest
    contract: the mask constrains the decode to one unambiguous
    byte-serialization, which is what a structured-output consumer
    parses."""
    if "enum" in schema:
        opts = []
        for v in schema["enum"]:
            if not isinstance(v, str):
                raise ValueError(f"enum supports strings, got {v!r}")
            opts.append('"' + _regex_escape(v) + '"')
        return "(" + "|".join(opts) + ")"
    t = schema.get("type")
    if t == "string":
        return _JSON_STRING
    if t == "integer":
        return _JSON_INT
    if t == "number":
        return _JSON_NUM
    if t == "boolean":
        return _JSON_BOOL
    if t == "null":
        return "null"
    if t == "array":
        item = json_schema_regex(schema.get("items", {"type": "integer"}))
        return "(\\[\\]|\\[" + item + "(," + item + ")*\\])"
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            return "\\{\\}"
        parts = []
        for name, sub in props.items():
            parts.append('"' + _regex_escape(name) + '":'
                         + json_schema_regex(sub))
        return "\\{" + ",".join(parts) + "\\}"
    raise ValueError(f"unsupported JSON schema: {schema!r}")


def _regex_escape(text):
    out = []
    for ch in text:
        if ch in "\\.[](){}|*+?^\"-":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


# -- token-level compiled grammar ----------------------------------------

class CompiledGrammar:
    """A DFA lifted to the TOKEN alphabet of one model: ``vocab[t]`` is
    the string token ``t`` emits (EOS's entry is ignored). Per-state
    ``[V]`` float32 additive masks (0.0 allowed / -1e9 banned) are
    cached here, shared by every request and beam on this grammar —
    the per-consumer state is just a DFA state id."""

    def __init__(self, dfa, vocab, eos_id):
        if eos_id is None:
            raise ValueError(
                "grammar-constrained decode needs an eos_id: EOS is how "
                "an accepting state terminates the generation")
        self.dfa = dfa
        self.vocab = [str(s) for s in vocab]
        self.eos_id = int(eos_id)
        self._masks = {}          # state -> float32 [V]
        self._steps = {}          # (state, token) -> state | None

    @classmethod
    def from_regex(cls, pattern, vocab, eos_id):
        alphabet = set()
        for i, s in enumerate(vocab):
            if i != eos_id:
                alphabet |= set(str(s))
        return cls(compile_regex(pattern, alphabet), vocab, eos_id)

    @classmethod
    def from_json_schema(cls, schema, vocab, eos_id):
        return cls.from_regex(json_schema_regex(schema), vocab, eos_id)

    @property
    def start_state(self):
        return self.dfa.start

    def token_step(self, state, token):
        key = (state, int(token))
        if key not in self._steps:
            if int(token) == self.eos_id:
                self._steps[key] = None
            else:
                self._steps[key] = self.dfa.walk(state,
                                                 self.vocab[int(token)])
        return self._steps[key]

    def mask(self, state):
        """Additive ``[V]`` float32 mask for ``state``: 0.0 where the
        token's string walks to a live state (or is EOS in an accepting
        state), ``NEG_INF`` elsewhere. Cached per state."""
        cached = self._masks.get(state)
        if cached is None:
            v = len(self.vocab)
            m = np.full((v,), np.float32(NEG_INF), dtype="float32")
            for t in range(v):
                if t == self.eos_id:
                    if self.dfa.accepting[state]:
                        m[t] = 0.0
                elif self.token_step(state, t) is not None:
                    m[t] = 0.0
            self._masks[state] = m
            cached = m
        return cached


class GrammarConstraint:
    """The per-request (or per-beam) cursor over a CompiledGrammar: one
    DFA state id plus the shared grammar. ``fork()`` is O(1) — beam
    forks clone grammar state for free."""

    __slots__ = ("grammar", "state")

    def __init__(self, grammar, state=None):
        self.grammar = grammar
        self.state = grammar.start_state if state is None else state

    def mask(self):
        return self.grammar.mask(self.state)

    def advance(self, token):
        """Consume an emitted token. EOS is terminal (state freezes);
        an emitted token the mask banned is a contract violation and
        raises — the engine never produces one, because selection runs
        over the masked logits."""
        if int(token) == self.grammar.eos_id:
            if not self.accepting():
                raise ValueError(
                    "EOS emitted in a non-accepting grammar state")
            return self
        nxt = self.grammar.token_step(self.state, token)
        if nxt is None:
            raise ValueError(
                f"token {int(token)} ({self.grammar.vocab[int(token)]!r}) "
                "is not allowed by the grammar here")
        self.state = nxt
        return self

    def accepting(self):
        return self.grammar.dfa.accepting[self.state]

    def fork(self):
        return GrammarConstraint(self.grammar, self.state)
