"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""

import contextlib
import threading


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.prefix = prefix
        self.ids = {}
        self._lock = threading.Lock()

    def __call__(self, key):
        with self._lock:
            self.ids[key] = self.ids.get(key, 0) + 1
            tmp = self.ids[key] - 1
        return self.prefix + "_".join([key, str(tmp)])


_generator = UniqueNameGenerator()


def generate(key):
    return _generator(key)


@contextlib.contextmanager
def guard(new_prefix=""):
    global _generator
    old = _generator
    _generator = UniqueNameGenerator(new_prefix)
    try:
        yield
    finally:
        _generator = old


def switch(new_generator=None):
    global _generator
    old = _generator
    _generator = new_generator or UniqueNameGenerator()
    return old
