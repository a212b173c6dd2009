"""DGC sparse gradient exchange over the port's data mesh: top-k select,
then an all-gather of (index, value) pairs.

reference: paddle/fluid/framework/details/sparse_all_reduce_op_handle.h —
each rank sparsifies its gradient to its top-k entries and exchanges only
(index, value) pairs, the communication saving of Deep Gradient
Compression (Lin et al.). The counterpart of the JAX package's
``parallel/dgc.py``, for training loops written directly against tensors:
each rank

  1. adds its gradient into a local error-feedback residual,
  2. selects the top-k entries by magnitude (descending, ties by lower
     index, as ``lax.top_k``),
  3. all-gathers the (index, value) pairs over the axis — 2*k*n values on
     the wire instead of the dense gradient,
  4. scatter-adds the gathered contributions in rank order into a dense
     update and clears what it sent from its residual.
"""

import torch

from paddle_tpu_torch.kernels.topk import topk_abs_exact
from paddle_tpu_torch.parallel import env as penv

__all__ = ["dgc_exchange_local", "dgc_allreduce"]


def dgc_exchange_local(grad, residual, k, axis):
    """``grad``/``residual``: this rank's flat ``[size]`` tensors; ``axis``
    an ``Axis`` of the mesh. Returns (the dense update ``[size]``, the mean
    of every rank's sparse contribution, the same on every rank; and the
    new residual)."""
    acc = residual + grad
    _, idx = topk_abs_exact(acc, k)
    vals = acc[idx.to(torch.int64)]
    new_residual = acc.clone()
    new_residual[idx.to(torch.int64)] = 0.0
    all_idx, all_vals = penv.all_gather_pairs(idx, vals.to(torch.float32),
                                              axis)
    update = torch.zeros_like(grad).index_put_(
        (all_idx.reshape(-1).to(torch.int64),),
        all_vals.reshape(-1).to(grad.dtype), accumulate=True) / axis.size
    return update, new_residual


def _leaves(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [tree]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), leaves))
    if isinstance(tree, (list, tuple)):
        return type(tree)(leaves)
    return leaves[0]


def dgc_allreduce(mesh, grads, residuals, sparsity=0.999, axis_name="data"):
    """Sparse-allreduce this rank's gradients: ``grads``/``residuals`` are
    a tensor, a list/tuple or a dict of tensors with a leading axis of 1
    (this rank's slice of the JAX package's ``[n_shards, ...]`` layout).
    Returns (updates, new_residuals) in the same layout; ``updates`` is
    the same on every rank (the aggregated sparse gradient)."""
    axis = mesh.axis(axis_name)
    ups, res = [], []
    for g, r in zip(_leaves(grads), _leaves(residuals)):
        g0, r0 = g[0].reshape(-1), r[0].reshape(-1)
        k = max(1, int(round(g0.numel() * (1.0 - sparsity))))
        upd, new_r = dgc_exchange_local(g0, r0, k, axis)
        ups.append(upd.reshape(g[0].shape)[None])
        res.append(new_r.reshape(r[0].shape)[None])
    return _rebuild(grads, ups), _rebuild(residuals, res)
