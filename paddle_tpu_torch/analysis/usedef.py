"""Producer/consumer maps of a block, the part of the JAX package's
``analysis/usedef.py`` (``build_usedef``, ``reads_of`` / ``writes_of``)
that the passes and ``Program._prune`` use.

The port's programs have no control-flow sub-blocks, so an op reads
exactly its input names and writes exactly its output names. A var read
twice by one op counts as two consumptions, as in the JAX package
(sole-consumer guards depend on it)."""

__all__ = ["UseDefMap", "build_usedef"]


class UseDefMap:
    """``producers[name]`` / ``consumers[name]``: the ops of ``block``
    that write / read ``name``, in program order."""

    def __init__(self, block):
        self.producers = {}
        self.consumers = {}
        for op in block.ops:
            for n in op.output_names():
                self.producers.setdefault(n, []).append(op)
            for n in op.input_names():
                self.consumers.setdefault(n, []).append(op)

    def reads_of(self, op):
        """The names ``op`` reads."""
        return set(op.input_names())

    def writes_of(self, op):
        """The names ``op`` writes."""
        return set(op.output_names())


def build_usedef(block):
    """A ``UseDefMap`` of ``block``."""
    return UseDefMap(block)
