"""Ops of the JAX package's ``ops/misc_extra.py``, with its semantics:

* the random ``*_batch_size_like`` ops: a declared shape whose
  ``output_dim_idx`` dimension is taken from ``Input``'s
  ``input_dim_idx`` one, filled with ``jax.random``'s values from the
  op's key (the bits from K8 on the card, as the random ops of
  ``ops/tensor.py`` draw them);
* the remote lookup pair ``distributed_lookup_table`` /
  ``distributed_push_sparse`` of ``layers.distributed_embedding``. In the
  JAX package they are ``io_callback``s inside one compiled step; here
  the lookup's lowering pulls on the host (``distributed/lookup.py``,
  from the host copy of the ids: ``Executor.run`` keeps the feed on the
  host) and uploads the rows to the card, and the push's lowering
  downloads the row grads and pushes them — a host sync each, per table
  per step, counted in the lookup context's ``stats``.
"""

import time

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.dtypes import to_torch_dtype
from paddle_tpu_torch.core.registry import get_op_def, register_op
from paddle_tpu_torch.ops.common import first, maybe, reduce_axes
from paddle_tpu_torch.ops.tensor import (
    batch_size_like_shape, draw, mean_std)
from paddle_tpu_torch.utils.enforce import EnforceError


@register_op("uniform_random_batch_size_like", stateful=True,
             nondiff_inputs=("Input",))
def _uniform_random_bsl(ins, attrs):
    """reference: paddle/fluid/operators/uniform_random_batch_size_like_op.cc."""
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return {"Out": [draw(ins, attrs, batch_size_like_shape(ins, attrs),
                         lambda b: prng.uniform(b, lo, hi),
                         first(ins, "Input").device)]}


@register_op("gaussian_random_batch_size_like", stateful=True,
             nondiff_inputs=("Input",))
def _gaussian_random_bsl(ins, attrs):
    """reference: paddle/fluid/operators/gaussian_random_batch_size_like_op.cc."""
    z = draw(ins, attrs, batch_size_like_shape(ins, attrs), prng.normal,
             first(ins, "Input").device)
    return {"Out": [mean_std(z, attrs)]}


# remote ids ride int32 in the JAX package (64-bit types off), which
# wraps an id >= 2^31 without a word; the port refuses one, so that both
# packages accept the same programs
_REMOTE_ID_LIMIT = 2 ** 31


def _remote_ids(ids):
    """The host ids of a remote table's occurrence: the feed as the
    executor kept it on the host, the trailing 1 squeezed."""
    from paddle_tpu_torch.distributed import lookup

    idv = lookup._host_array(ids)
    if idv.ndim >= 2 and idv.shape[-1] == 1:
        idv = idv[..., 0]
    if idv.size and (int(idv.max()) >= _REMOTE_ID_LIMIT or int(idv.min()) < 0):
        raise EnforceError(
            "distributed_embedding ids must lie in [0, 2^31) (the JAX "
            f"package carries them as int32); got ids in [{int(idv.min())}, "
            f"{int(idv.max())}] — pre-hash them or use sparse_embedding")
    return idv


@register_op("distributed_lookup_table", nondiff_inputs=("Ids",), creates=True)
def _distributed_lookup_table(ins, attrs):
    """reference: paddle/fluid/operators/distributed_ops/
    distributed_lookup_table_op.cc — embedding lookup against a
    parameter-server table. Two forms:

    * W present (single-process semantic): dense gather from the local
      table — what the reference computes once the rows are fetched.
    * no W (the PS fleet form, layers.distributed_embedding): the table
      exists ONLY on the servers; the lowering pulls the batch's rows on
      the host (prefetch-aware, distributed/lookup.py) and uploads them.
      With no active worker context it RAISES — a ported PS program must
      not silently train on a local table."""
    w = maybe(ins, "W")
    if w is not None:
        outs = []
        for ids in ins["Ids"]:
            idv = ids[..., 0] if ids.dim() >= 2 and ids.shape[-1] == 1 else ids
            out = w.index_select(0, idv.reshape(-1).to(torch.int64)).reshape(
                tuple(idv.shape) + tuple(w.shape[1:]))
            pad = attrs.get("padding_idx", -1)
            if pad is not None and pad >= 0:
                out = torch.where((idv == pad).unsqueeze(-1),
                                  torch.zeros((), dtype=out.dtype,
                                              device=out.device), out)
            outs.append(out)
        return {"Outputs": outs}
    from paddle_tpu_torch.distributed import lookup

    name = attrs.get("table_name")
    ctx = lookup.active_context()
    if ctx is None or not ctx.has(name):
        raise EnforceError(
            f"distributed_lookup_table('{name}') is a remote PS table but "
            "no remote-lookup context is active. Run this program through "
            "the PS fleet (fleet.init_worker() registers the table and "
            "activates the context); refusing to compute a local-dense "
            "answer instead."
        )
    device = ins["__device__"][0]
    outs = []
    for ids in ins["Ids"]:
        t0 = time.perf_counter()
        rows = lookup.pull_host(name, _remote_ids(ids))
        ctx.stats["pull_seconds"] += time.perf_counter() - t0
        out = torch.from_numpy(np.ascontiguousarray(rows))
        if device.type == "cuda":
            ctx.stats["uploads"] += 1
            out = out.pin_memory().to(device, non_blocking=True)
        outs.append(out)
    return {"Outputs": outs}


@register_op("distributed_push_sparse", nondiff_inputs=("Ids",))
def _distributed_push_sparse(ins, attrs):
    """Backward half of the remote lookup: push the batch's merged row
    grads to the servers (the server update is a side effect, sequenced
    before the next step's pull: the op runs where the JAX package's
    ordered callback does). reference: the send/prefetch pair in
    distributed_ops/prefetch_op.cc:1 + communicator send path."""
    from paddle_tpu_torch.distributed import lookup

    name = attrs.get("table_name")
    ids, grad = first(ins, "Ids"), first(ins, "Grad")
    ctx = lookup.active_context()
    t0 = time.perf_counter()
    if grad.is_cuda and ctx is not None:
        ctx.stats["downloads"] += 1
    host_grad = grad.detach().to("cpu", torch.float32).numpy()
    lookup.push_host(name, _remote_ids(ids), host_grad)
    if ctx is not None:
        ctx.stats["push_seconds"] += time.perf_counter() - t0
    return {}


# -- M12a: the common ops of the JAX package's ``ops/misc_extra.py`` ---------


@register_op("fill_any_like")
def _fill_any_like(ins, attrs):
    """reference: paddle/fluid/operators/fill_any_like_op.cc."""
    return {"Out": [torch.full_like(first(ins, "X"), attrs.get("value", 0.0))]}


def _bool_reduce(ins, attrs, fn):
    x = first(ins, "X").to(torch.bool)
    if attrs.get("reduce_all", False):
        return fn(x)
    dims = reduce_axes(attrs, x.dim())
    return fn(x, dim=dims, keepdim=attrs.get("keep_dim", False))


@register_op("reduce_all", nondiff_inputs=("X",))
def _reduce_all(ins, attrs):
    """reference: paddle/fluid/operators/reduce_ops/reduce_all_op.cc; with
    ``reduce_all`` a 0-d bool, as in the JAX package."""
    return {"Out": [_bool_reduce(ins, attrs, torch.all)]}


@register_op("reduce_any", nondiff_inputs=("X",))
def _reduce_any(ins, attrs):
    return {"Out": [_bool_reduce(ins, attrs, torch.any)]}


def _v1(name, v2):
    """The v1 op ``name``: ``v2``'s lowering without its XShape
    (reference: paddle/fluid/operators/squeeze_op.cc, flatten_op.cc,
    unsqueeze_op.cc)."""
    @register_op(name)
    def _lower(ins, attrs):
        return {"Out": get_op_def(v2).lower(ins, attrs)["Out"]}


_v1("squeeze", "squeeze2")
_v1("flatten", "flatten2")
_v1("unsqueeze", "unsqueeze2")


def _unique(x, attrs, counts):
    """``jnp.unique(x, size=len(x), fill_value=x[-1])`` of flattened X:
    the sorted uniques first, the tail filled with X's LAST ELEMENT; the
    index of each element's unique; the counts, 0 in the tail. Index and
    counts in the ``dtype`` attribute (int32 by default). The number of
    uniques depends on the data: on the card the call syncs with the
    host."""
    x = x.reshape(-1)
    it = to_torch_dtype(attrs.get("dtype", "int32"))
    if x.is_meta:   # shape inference: every output keeps X's length
        out = {"Out": [torch.empty_like(x)],
               "Index": [torch.empty_like(x, dtype=it)]}
        if counts:
            out["Count"] = [torch.empty_like(x, dtype=it)]
        return out
    uniq, inverse, count = torch.unique(x, sorted=True, return_inverse=True,
                                        return_counts=True)
    tail = x.shape[0] - uniq.shape[0]
    out = {"Out": [torch.cat([uniq, x[-1:].expand(tail)])],
           "Index": [inverse.to(it)]}
    if counts:
        out["Count"] = [torch.cat([count, count.new_zeros(tail)]).to(it)]
    return out


@register_op("unique", nondiff_inputs=("X",))
def _unique_op(ins, attrs):
    """reference: paddle/fluid/operators/unique_op.h, in the JAX package's
    static-shape form (``_unique``)."""
    return _unique(first(ins, "X"), attrs, counts=False)


@register_op("unique_with_counts", nondiff_inputs=("X",))
def _unique_with_counts(ins, attrs):
    """reference: paddle/fluid/operators/unique_with_counts_op.h."""
    return _unique(first(ins, "X"), attrs, counts=True)
