"""The port's reader decorators (``paddle_tpu_torch/reader/decorator.py``)
against the JAX package's on the same readers: every decorator's output
equal, the seeded ``shuffle`` order, ``xmap_readers(order=True)``,
``robust``'s skips and restarts (counted on each package's registry),
and errors surfacing where they occur."""

import random

import pytest

from paddle_tpu.observability import registry as jax_registry
from paddle_tpu.reader import decorator as jax_dec
from paddle_tpu_torch.observability import registry as torch_registry
from paddle_tpu_torch.reader import decorator as dec


def _reader(n=23):
    return lambda: iter(range(n))


def _pair(name, *args, **kwargs):
    """``list(decorator(*args)())`` in both packages."""
    return (list(getattr(jax_dec, name)(*args, **kwargs)()),
            list(getattr(dec, name)(*args, **kwargs)()))


@pytest.mark.parametrize("case", [
    ("batch", (_reader(), 5), {}),
    ("batch", (_reader(), 5), {"drop_last": True}),
    ("shuffle", (_reader(), 7), {"seed": 3}),
    ("shuffle", (_reader(50), 64), {"seed": 11}),
    ("chain", (_reader(4), _reader(3)), {}),
    ("compose", (_reader(6), lambda: iter("abcdef")), {}),
    ("compose", (_reader(6), lambda: iter("abc")), {"check_alignment": False}),
    ("firstn", (_reader(), 9), {}),
    ("buffered", (_reader(), 3), {}),
    ("map_readers", (lambda a, b: a * 10 + b, _reader(5), _reader(5)), {}),
    ("cache", (_reader(8),), {}),
])
def test_each_decorator_equals_the_jax_one(case):
    name, args, kwargs = case
    want, got = _pair(name, *args, **kwargs)
    assert got == want and got


def test_seeded_shuffle_replays_and_leaves_the_global_rng_alone():
    random.seed(99)
    state = random.getstate()
    r = dec.shuffle(_reader(40), 16, seed=5)
    first, second = list(r()), list(r())
    assert first == second == list(jax_dec.shuffle(_reader(40), 16, seed=5)())
    assert sorted(first) == list(range(40)) and first != list(range(40))
    assert random.getstate() == state


@pytest.mark.parametrize("workers,buf", [(1, 2), (3, 4), (4, 1)])
def test_xmap_readers_in_order_equals_the_jax_one(workers, buf):
    def slow_square(x):
        # an uneven cost, so the workers finish out of order
        for _ in range((x % 4) * 2000):
            pass
        return x * x

    want = list(jax_dec.xmap_readers(slow_square, _reader(40), workers, buf,
                                     order=True)())
    got = list(dec.xmap_readers(slow_square, _reader(40), workers, buf,
                                order=True)())
    assert got == want == [x * x for x in range(40)]
    unordered = list(dec.xmap_readers(slow_square, _reader(40), workers, buf)())
    assert sorted(unordered) == want


def test_xmap_and_buffered_raise_where_the_reader_fails():
    def bad():
        yield 1
        yield 2
        raise ValueError("boom at 3")

    for mod in (dec, jax_dec):
        with pytest.raises(ValueError, match="boom at 3"):
            list(mod.buffered(bad, 2)())
        with pytest.raises(ValueError, match="boom at 3"):
            list(mod.xmap_readers(lambda x: x, bad, 2, 2)())

    def bad_map(x):
        if x == 4:
            raise KeyError("mapper 4")
        return x

    for mod in (dec, jax_dec):
        with pytest.raises(KeyError, match="mapper 4"):
            list(mod.xmap_readers(bad_map, _reader(8), 2, 2, order=True)())


def test_compose_misaligned_readers_raise_in_both():
    for mod in (dec, jax_dec):
        with pytest.raises(RuntimeError, match="different lengths"):
            list(mod.compose(_reader(3), _reader(4))())


class _Flaky:
    """A class-based iterator raising at the given positions (it goes on
    past each bad record)."""

    def __init__(self, n, bad):
        self.i, self.n, self.bad = 0, n, set(bad)

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        i = self.i
        self.i += 1
        if i in self.bad:
            raise IOError(f"bad record {i}")
        return i


def _gen_flaky(n, bad, state):
    """A generator reader that dies at each position of ``bad`` on its
    first pass over it (a transient fault: the restart reads it)."""
    def reader():
        for i in range(n):
            if i in bad and i not in state:
                state.add(i)
                raise IOError(f"transient {i}")
            yield i
    return reader


def _skips(reg):
    return reg().counter("reader_skipped_records_total",
                         "records skipped by fluid.io.robust readers").value


@pytest.mark.parametrize("kind", ["iterator", "generator"])
def test_robust_skips_and_restarts_like_the_jax_one(kind):
    out, counts = {}, {}
    for name, mod, reg in (("jax", jax_dec, jax_registry),
                           ("torch", dec, torch_registry)):
        before = _skips(reg)
        if kind == "iterator":
            r = mod.robust(lambda: _Flaky(12, {2, 5, 9}), max_skips=4)
        else:
            r = mod.robust(_gen_flaky(12, {3, 7}, set()), max_skips=4,
                           max_restarts=3)
        out[name] = list(r())
        counts[name] = _skips(reg) - before
    assert out["torch"] == out["jax"]
    assert counts["torch"] == counts["jax"] == (3 if kind == "iterator" else 2)
    if kind == "iterator":
        assert out["torch"] == [i for i in range(12) if i not in {2, 5, 9}]
    else:
        # a restarted generator fast-forwards past the bad record
        assert out["torch"] == [i for i in range(12) if i not in {3, 7}]


def test_robust_bounds_surface_the_error_in_both():
    for mod in (dec, jax_dec):
        with pytest.raises(IOError, match="bad record"):
            list(mod.robust(lambda: _Flaky(20, range(0, 20, 2)),
                            max_skips=3)())

        def always_dies():
            yield 0
            raise IOError("dead")

        with pytest.raises(IOError, match="dead"):
            list(mod.robust(always_dies, max_restarts=2)())
