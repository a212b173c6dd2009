"""Global flag registry with an environment-variable bridge, copied from
the JAX package's ``utils/flags.py`` for the flags the port reads
(same names, same defaults). A flag may be set with a ``FLAGS_<name>``
environment variable or at run time with ``flags.<name> = value``."""

import os

__all__ = ["flags"]


class _FlagRegistry:
    def __init__(self):
        object.__setattr__(self, "_defs", {})
        object.__setattr__(self, "_values", {})

    def define(self, name, default, help="", check=None):
        """``check(value)``, where given, raises on a value the port does
        not take, when the flag is set (from the environment too)."""
        self._defs[name] = (type(default), default, help, check)
        env = os.environ.get("FLAGS_" + name)
        value = _parse(type(default), env) if env is not None else default
        if check is not None:
            check(value)
        self._values[name] = value

    def __getattr__(self, name):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"undefined flag FLAGS_{name}") from None

    def __setattr__(self, name, value):
        if name not in self._defs:
            raise AttributeError(f"undefined flag FLAGS_{name}")
        ty, _, _, check = self._defs[name]
        value = _parse(ty, value) if isinstance(value, str) else ty(value)
        if check is not None:
            check(value)
        self._values[name] = value


def _parse(ty, s):
    if ty is bool:
        return s if isinstance(s, bool) else str(s).lower() in ("1", "true", "yes")
    return ty(s)


flags = _FlagRegistry()


flags.define(
    "sparse_embedding_update", True,
    "fuse lookup_table_grad + sgd into a row-sparse update (SelectedRows "
    "analog): the [V, D] dense embedding gradient never materializes",
)
flags.define(
    "pallas_sparse_update", False,
    "serve sgd_sparse's row update through the hand-written sparse-row "
    "kernel (kernels/sparse_update.py) instead of one accumulating "
    "index_put_ (the name is the JAX package's flag)",
)
flags.define(
    "dgc_sparse_exchange", True,
    "DGCMomentumOptimizer under a data-parallel CompiledProgram exchanges "
    "top-k (index, value) pairs per rank (2*k*n values on the wire) "
    "instead of the dense gradient; 0 runs the dense fused form (the "
    "grads all-reduced, then dgc_momentum with no exchange)",
)
flags.define(
    "pallas_dgc_topk", False,
    "serve the DGC sparse exchange's top-k through the blocked top-k "
    "kernel (kernels/topk.py) instead of one exact sort of |v| (the name "
    "is the JAX package's flag)",
)
def _threefry_only(impl):
    if impl != "threefry":
        raise NotImplementedError(
            f"FLAGS_rng_impl={impl!r}: the port draws only threefry2x32, "
            "jax.random's default, whose bytes it gives on the card; the "
            "JAX package's 'rbg' streams come from XLA's RngBitGenerator "
            "(ROADMAP queue C)")


flags.define(
    "rng_impl", "threefry",
    "PRNG implementation for stateful ops (dropout, the random ops): only "
    "'threefry', jax.random's default, whose bytes the port gives on the "
    "card through K8 (kernels/random.py); the JAX package's 'rbg' and "
    "'unsafe_rbg' draw from XLA's RngBitGenerator, whose bytes the port "
    "cannot give, and raise NotImplementedError when set",
    check=_threefry_only,
)
flags.define("amp_dtype", "bfloat16",
             "low-precision dtype of the AMP rewrite (amp.decorate)")
