"""Scope: name -> torch tensor state, with parent-chain lookup.

Analog of the reference's Scope (reference:
paddle/fluid/framework/scope.h:46). A Scope holds torch tensors; the
executor reads them as op inputs and writes persistables back after a
run. Unlike the JAX package, where arrays are immutable and buffer
donation stands in for mutation, a persistable the program rewrites (the
KV arenas) may be updated in place by the executor.
"""

import contextlib


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent
        self.kids = []
        if parent is not None:
            parent.kids.append(self)

    def new_scope(self):
        return Scope(parent=self)

    def set(self, name, value):
        self._vars[name] = value

    def _find_owner(self, name):
        scope = self
        while scope is not None:
            if name in scope._vars:
                return scope
            scope = scope.parent
        return None

    def find_var(self, name):
        owner = self._find_owner(name)
        return owner._vars[name] if owner is not None else None

    def has_var(self, name):
        return self.find_var(name) is not None

    def var_names(self):
        return list(self._vars)

    def erase(self, names):
        for n in names:
            self._vars.pop(n, None)

    def find_var_numpy(self, name):
        v = self.find_var(name)
        return None if v is None else v.detach().cpu().numpy()

    def drop_kids(self):
        self.kids = []


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old
