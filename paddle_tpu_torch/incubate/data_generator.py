"""User-side dataset line parsers emitting the MultiSlot text format.

reference: python/paddle/fluid/incubate/data_generator/__init__.py:21
(DataGenerator base — users subclass, implement generate_sample(line)
returning an iterator of (slot_name, values) pairs; run_from_stdin pipes
raw lines in, MultiSlot text out). The port's copy of the JAX package's
``incubate/data_generator.py``: the output format is exactly what the
native datafeed parses (``native/csrc/datafeed.cc`` parse_line:
"per slot: <count> v0 v1 ..."), so generated files plug straight into
InMemoryDataset/QueueDataset of either package.
"""

import sys

from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["DataGenerator", "MultiSlotDataGenerator"]


class DataGenerator:
    def __init__(self):
        self.batch_size_ = 32
        self._line_limit = None

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    # -- to be provided by the subclass --------------------------------
    def generate_sample(self, line):
        """Return a callable yielding (slot_name, list-of-values) pairs for
        one raw input line (or None to drop the line)."""
        raise NotImplementedError(
            "implement generate_sample(line) in your DataGenerator subclass"
        )

    def generate_batch(self, samples):
        """Optional batch-level hook: receives the list of samples of one
        batch; yields processed samples. Default passthrough."""

        def local_iter():
            for s in samples:
                yield s

        return local_iter

    # -- drivers --------------------------------------------------------
    def _format(self, sample):
        """[(name, values), ...] -> MultiSlot text line."""
        parts = []
        for _name, values in sample:
            enforce(
                isinstance(values, (list, tuple)) and len(values) > 0,
                f"slot '{_name}' must carry a non-empty list of values",
            )
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts)

    def run_from_stdin(self, out=None):
        self._run(sys.stdin, out or sys.stdout)

    def run_from_file(self, path, out_path):
        with open(path) as fin, open(out_path, "w") as fout:
            self._run(fin, fout)

    def run_from_memory(self, lines, out=None):
        """Process an iterable of raw lines; returns the output lines when
        `out` is None."""
        collected = []

        class _Sink:
            def write(self, s):
                collected.append(s)

        self._run(iter(lines), out or _Sink())
        if out is None:
            return [l for l in "".join(collected).splitlines() if l]

    def _run(self, lines_in, out):
        batch = []
        n = 0
        for line in lines_in:
            it = self.generate_sample(line)
            if it is None:
                continue
            for sample in it():
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) >= self.batch_size_:
                    self._flush(batch, out)
                    batch = []
            n += 1
            if self._line_limit and n >= self._line_limit:
                break
        if batch:
            self._flush(batch, out)

    def _flush(self, batch, out):
        for sample in self.generate_batch(batch)():
            out.write(self._format(sample) + "\n")


class MultiSlotDataGenerator(DataGenerator):
    """Name kept for reference parity (reference: data_generator/
    __init__.py:282 MultiSlotDataGenerator — the MultiSlot text formatter
    is already the base behavior here)."""
