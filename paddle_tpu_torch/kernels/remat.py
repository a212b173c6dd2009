"""The remat policy table, copied from the JAX package's
``kernels/remat.py``: the names ``RecomputeOptimizer(policy=)`` accepts,
the default, and the check that refuses any other name.

It is a table, not a kernel. The JAX package maps each name onto a
``jax.checkpoint`` policy, which decides what a traced replay keeps. The
port has no traced replay: the forward runs as the program's own ops, and
each segment's ``recompute_segment_grad`` replays the segment later
(``ops/recompute.py``). So here a policy decides which of a segment's
interior values the executor keeps alive, after their last forward
reader, for the grad op. That is the name list ``core/backward.py``
stamps on the op as ``__segment_saved_names__[policy]``:

* ``full`` keeps nothing: every interior value is dropped after its last
  forward reader, and the replay recomputes the segment;
* ``dots`` and ``dots_no_batch`` keep the outputs of the products
  (``DOT_OPS``). The replay takes a kept product as it is and does not
  recompute it; its backward is autograd's own for the product;
* ``save_all`` keeps every interior value: the no-remat memory profile,
  the control. The replay takes the kept products, and recomputes the
  rest (an eager op's autograd graph exists only once the op has run).

Every policy replays the same ops on the same values with the same
random keys, so the grads are the same bits under all four.
"""

from paddle_tpu_torch.utils.enforce import EnforceError

__all__ = ["POLICY_NAMES", "DEFAULT_POLICY", "DOT_OPS", "validate_policy",
           "kept_names"]

DEFAULT_POLICY = "full"

POLICY_NAMES = ("full", "dots", "dots_no_batch", "save_all")

#: the op types whose outputs the ``dots`` policies keep (the same list
#: as the JAX package's ``core/backward.py`` ``_make_segment_op``)
DOT_OPS = frozenset(("mul", "matmul", "matmul_v2", "conv2d",
                     "depthwise_conv2d"))


def validate_policy(name):
    if name not in POLICY_NAMES:
        raise EnforceError(
            f"unknown remat policy {name!r} (want one of {POLICY_NAMES})"
        )
    return name


def kept_names(attrs):
    """The interior values the policy of a ``recompute_segment_grad`` op
    (its ``attrs``) keeps for it."""
    policy = validate_policy(attrs.get("__remat_policy__", DEFAULT_POLICY))
    return list(attrs["__segment_saved_names__"][policy])
