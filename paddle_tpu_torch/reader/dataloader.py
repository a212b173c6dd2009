"""DataLoader: multi-worker batch assembly + device-prefetching iterator.

Reference: python/paddle/fluid/reader.py — DataLoader.from_generator :168
backed by a C++ blocking queue (reader/lod_tensor_blocking_queue.h) with
double-buffer prefetch to GPU (reader/buffered_reader.cc). The port's
copy of the JAX package's ``reader/dataloader.py``: the host pipeline
rides ``dataio`` — ``num_workers`` batches are assembled concurrently by
the deterministic ordered worker pool (round-robin reassembly: output
order is independent of worker timing), and ``DevicePrefetcher`` stages
each batch on the card ahead of use, from pinned buffers on a side
stream, so the copy overlaps the current step's compute.

Placement: the batches go to the device of ``places`` (the first, when a
list; the first card when None). A feed that the host reads stays on the
host as a numpy array: the raw ids of the program's sharded, PS and
remote tables (``core.executor.host_read_feeds``), which
``EmbeddingEngine.prepare_feed``, the PS worker and the remote lookup
read on the host. The JAX package device-puts the whole batch.

Fed batches are validated against their feed vars here (dtype/shape by
name, data_feeder.check_feed_array) — a mismatched feed fails at the
loader with the variable named instead of as an opaque downstream
lowering error.
"""

from paddle_tpu_torch.data_feeder import DataFeeder, check_feed_array
from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["DataLoader", "PyReader"]


class _GeneratorLoader:
    def __init__(self, feed_list, capacity, return_list, num_workers=0):
        self._feed_list = feed_list
        self._capacity = capacity
        self._return_list = return_list
        self._num_workers = int(num_workers)
        self._reader = None
        self._places = None
        self._feeder = None
        self._batch_reader = None
        self._sample_transform = None

    def _var_specs(self):
        """(name, dtype, shape) per feed var; dtype/shape None for bare
        string entries (no declaration to check against)."""
        specs = []
        for v in self._feed_list:
            if isinstance(v, str):
                specs.append((v, None, None))
            else:
                specs.append((v.name, v.dtype, v.shape))
        return specs

    # -- configuration (reference: reader.py set_sample_generator etc.) ----
    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None, sample_transform=None):
        """`sample_transform` (optional) is a per-sample preprocess
        (decode/augment) applied on the worker pool when num_workers > 0
        — the CPU-bound stage tools/bench_input.py measures."""
        from paddle_tpu_torch.reader import decorator

        self._sample_transform = sample_transform
        self.set_sample_list_generator(
            decorator.batch(reader, batch_size, drop_last=drop_last), places
        )
        return self

    def set_sample_list_generator(self, reader, places=None):
        feeder = DataFeeder(self._feed_list)
        transform = self._sample_transform
        num_workers = self._num_workers

        def assemble(samples):
            if transform is not None:
                samples = [transform(s) for s in samples]
            return feeder.feed(samples)

        def batch_reader():
            from paddle_tpu_torch.dataio.engine import parallel_map_ordered

            # num_workers=0 runs the pool's synchronous path: same
            # ordering/error contract, same spans and queue metrics
            yield from parallel_map_ordered(
                reader(), assemble, num_workers, name="dataloader",
            )

        self._batch_reader = batch_reader
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        specs = self._var_specs()
        names = [s[0] for s in specs]

        def check(batch):
            if not isinstance(batch, dict):
                batch = dict(zip(names, batch))
            missing = [n for n in names if n not in batch]
            enforce(
                not missing,
                f"fed batch is missing feed variable(s) {missing}; "
                f"expected {names}",
            )
            # validate declared vars in place; keys beyond the feed list
            # (auxiliary feeds) pass through untouched
            out = dict(batch)
            for n, dtype, shape in specs:
                if dtype is not None or shape is not None:
                    out[n] = check_feed_array(n, batch[n], dtype, shape)
            return out

        def batch_reader():
            from paddle_tpu_torch.dataio.engine import parallel_map_ordered

            yield from parallel_map_ordered(
                reader(), check, self._num_workers, name="dataloader",
            )

        self._batch_reader = batch_reader
        self._places = places
        return self

    # -- iteration ---------------------------------------------------------
    def _host_keys(self):
        """The feeds of the feed list's program that the host reads."""
        from paddle_tpu_torch.core.executor import host_read_feeds

        for v in self._feed_list:
            if not isinstance(v, str):
                return host_read_feeds(v.block.program)
        return set()

    def __iter__(self):
        from paddle_tpu_torch.dataio.prefetch import DevicePrefetcher

        enforce(self._batch_reader is not None, "no generator set on DataLoader")
        names = [v if isinstance(v, str) else v.name for v in self._feed_list]
        places = self._places
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        # async H2D double buffer: the copy of batch N overlaps step N-1
        # (the producer thread stages ahead); distinct pipeline label:
        # the pool's reassembly wait and the training loop's prefetch
        # wait are different stalls
        prefetcher = DevicePrefetcher(
            self._batch_reader(), depth=self._capacity, device=places,
            host_keys=self._host_keys(), name="dataloader-prefetch",
        )
        for item in prefetcher:
            if self._return_list:
                yield [item[n] for n in names]
            else:
                yield item


class DataLoader:
    @staticmethod
    def from_generator(
        feed_list=None,
        capacity=16,
        use_double_buffer=True,
        iterable=True,
        return_list=False,
        use_multiprocess=False,
        num_workers=0,
    ):
        """Reference: python/paddle/fluid/reader.py:168. use_double_buffer /
        use_multiprocess are accepted for parity: prefetch is always on (the
        producer thread stages ahead). `num_workers > 0` assembles
        batches on the dataio ordered worker pool — same batch order as
        num_workers=0 (round-robin reassembly), more throughput when the
        per-batch work (sample_transform + numpy stacking) is CPU-bound."""
        return _GeneratorLoader(feed_list or [], capacity, return_list,
                                num_workers=num_workers)

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        """Iterate a Dataset (``dataset.py``) as feed dicts of host
        arrays, as the JAX package does (the executor moves them)."""

        class _DatasetLoader:
            def __iter__(self):
                return dataset._iter_batches(drop_last=drop_last)

        return _DatasetLoader()


class PyReader(_GeneratorLoader):
    """Non-iterable start/reset flavor (reference: reader.py:971 PyReader)."""

    def __init__(self, feed_list=None, capacity=16, use_double_buffer=True,
                 iterable=True, return_list=False, num_workers=0):
        super().__init__(feed_list or [], capacity, return_list,
                         num_workers=num_workers)
        self._iter = None

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places)

    def start(self):
        self._iter = iter(self)

    def reset(self):
        self._iter = None

    def next(self):
        enforce(self._iter is not None, "call start() first")
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = None
            raise
