"""Control-flow-aware use-def and liveness analysis over a Block, the
port's copy of the JAX package's ``analysis/usedef.py``: the one shared
producer/consumer/live-var computation for every IR rewrite.

A ``while`` / ``conditional_block`` op lists only its Condition var, so a
var read *inside* a loop body would be invisible to a consumer map built
from op descs alone, and a fusion pass could delete its producer. Here
every control-flow op is credited with its whole sub-tree's reads and
writes (nested sub-blocks included), so a sub-block read shows up in the
consumer map attributed to the control-flow op itself and defeats
sole-consumer fusion guards. A var read twice by one op counts as two
consumptions (sole-consumer guards depend on it).

Reference machinery: paddle/fluid/framework/ir/graph_helper.cc (graph
topology), paddle/fluid/framework/prune.cc (dependence pruning) and the
memory-optimize pass's liveness.
"""

__all__ = [
    "SUB_BLOCK_ATTRS",
    "UseDefMap",
    "build_usedef",
    "live_ops",
    "live_var_sets",
    "subtree_io",
]

#: op attrs that hold a sub-block index (while/conditional_block/recurrent)
SUB_BLOCK_ATTRS = ("sub_block", "sub_block_false")

#: op types whose execution has host-visible side effects — never dead
SIDE_EFFECT_OPS = frozenset({
    "print", "py_func", "distributed_push_sparse",
    "push_box_sparse", "save", "save_combine",
})


def sub_block_indices(op):
    """Sub-block indices referenced by `op`'s attrs (skips -1 sentinels)."""
    out = []
    for attr in SUB_BLOCK_ATTRS:
        idx = op.attrs.get(attr)
        if idx is not None and idx >= 0:
            out.append(idx)
    return out


def subtree_io(program, op, reads, writes, _visited=None):
    """Accumulate all names read/written by `op` including nested
    sub-blocks. An out-of-range or already-visited sub-block index is
    skipped instead of recursing forever (the verifier reports those)."""
    reads.update(op.input_names())
    writes.update(op.output_names())
    visited = set() if _visited is None else _visited
    for idx in sub_block_indices(op):
        if idx in visited or idx >= program.num_blocks():
            continue
        visited.add(idx)
        for sop in program.block(idx).ops:
            subtree_io(program, sop, reads, writes, visited)


class UseDefMap:
    """Producer/consumer maps for one block, sub-tree aware.

    ``producers[name]`` / ``consumers[name]`` list the block's own ops that
    (transitively, through sub-blocks they run) write/read ``name``, in
    program order. ``protected`` holds names that must survive any
    rewrite: the fetch names and every persistable var of the block
    (feeds are not protected: a rewrite may absorb a fed intermediate as
    long as it keeps reading it)."""

    def __init__(self, block, fetch_names=(), include_sub_blocks=True):
        self.block = block
        self.fetch_names = list(fetch_names)
        self.producers = {}
        self.consumers = {}
        self._reads_of = {}
        self._writes_of = {}
        program = block.program
        for op in block.ops:
            direct_reads = op.input_names()
            direct_writes = op.output_names()
            reads = set(direct_reads)
            writes = set(direct_writes)
            if include_sub_blocks and sub_block_indices(op):
                subtree_io(program, op, reads, writes)
            self._reads_of[id(op)] = reads
            self._writes_of[id(op)] = writes
            # direct uses keep their multiplicity; sub-block uses are
            # attributed to this op once each
            for n in direct_writes:
                self.producers.setdefault(n, []).append(op)
            for n in writes.difference(direct_writes):
                self.producers.setdefault(n, []).append(op)
            for n in direct_reads:
                self.consumers.setdefault(n, []).append(op)
            for n in reads.difference(direct_reads):
                self.consumers.setdefault(n, []).append(op)
        self.protected = set(fetch_names)
        for v in block.vars.values():
            if v.persistable:
                self.protected.add(v.name)

    def reads_of(self, op):
        """Names `op` reads (sub-tree included), as computed at build time."""
        return self._reads_of.get(id(op), set(op.input_names()))

    def writes_of(self, op):
        """Names `op` writes (sub-tree included)."""
        return self._writes_of.get(id(op), set(op.output_names()))

    def sole_consumer(self, name, op=None):
        """The single op consuming `name`, or None if the var escapes
        (several readers, sub-block readers included, fetched, or
        persistable). With `op`, the consumer must also BE `op`."""
        if name in self.protected:
            return None
        cons = self.consumers.get(name, [])
        if len(cons) != 1:
            return None
        if op is not None and cons[0] is not op:
            return None
        return cons[0]

    def sole_producer(self, name):
        prods = self.producers.get(name, [])
        return prods[0] if len(prods) == 1 else None


def build_usedef(block, fetch_names=(), include_sub_blocks=True):
    """A ``UseDefMap`` of ``block`` (the one entry point passes use)."""
    return UseDefMap(block, fetch_names, include_sub_blocks)


def live_ops(block, fetch_names):
    """Dead-op elimination before planning (reference: paddle/fluid/
    framework/prune.cc): keep ops that (transitively) feed a fetch, write
    persistable state, or have side effects. Control-flow ops count with
    their whole sub-tree's reads and writes."""
    needed = set(fetch_names)
    keep = [False] * len(block.ops)
    usedef = UseDefMap(block, fetch_names)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if op.type in ("feed", "fetch"):
            continue
        reads = usedef.reads_of(op)
        writes = usedef.writes_of(op)
        writes_persistable = any(
            (v := block._find_var_recursive(n)) is not None and v.persistable
            for n in writes
        )
        if (
            writes_persistable
            or op.type in SIDE_EFFECT_OPS
            or (writes & needed)
        ):
            keep[i] = True
            needed.update(reads)
    return [op for op, k in zip(block.ops, keep) if k]


def live_var_sets(block, fetch_names):
    """Backward liveness: ``live[i]`` is the set of names live *after*
    ``block.ops[i]`` executes (read by a later op or fetched). Persistable
    names are always live; sub-block reads count through their
    control-flow op. Returns a list of len(block.ops) sets."""
    usedef = UseDefMap(block, fetch_names)
    persistable = {v.name for v in block.vars.values() if v.persistable}
    live_after = set(fetch_names) | persistable
    out = [set()] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        out[i] = set(live_after)
        live_after = (live_after - usedef.writes_of(op)) \
            | usedef.reads_of(op) | persistable
    return out
