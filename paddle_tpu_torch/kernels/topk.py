"""Blocked top-k of |x|: the DGC wire builder (K7).

``blocked_topk_abs(x, k, block)`` returns the top ``k`` values of ``|x|``
of a 1-D ``x`` and their indices, exactly ``lax.top_k``'s result:
descending value, ties by lower index; float32 values, int32 indices. It
replaces the JAX package's ``paddle_tpu/ops/pallas/topk.py`` (the Pallas
kernel's ``pl.pallas_call`` at :66), with the same contract:

* below ``n <= 2k`` or ``n <= block`` it is the exact top-k of the whole
  vector, without the kernel (``topk_abs_exact``);
* otherwise a per-block stage keeps each block's top ``min(k, block)``
  entries (pad lanes past ``n`` count as -1 and are never chosen), and an
  exact selection over those candidates gives the result. Every global
  top-k element is in its own block's top ``min(k, block)``, so the result
  stays exact for any ``k``, also for ``k > block`` (the Pallas body's
  ``lax.top_k(v, k)`` cannot trace that).

The stage lists each block's candidates in index order, blocks in order,
so the candidates are in global index order and a stable descending sort
over them (``_select``) breaks ties by lower index. Here:

* ``blocked_topk_stage_plain`` — the plain version of the stage: pad to
  ``[nb, block]`` with -1, a stable descending sort per row, the first
  ``min(k, block)``, put back in index order;
* ``blocked_topk_stage`` — the wrapper of the stage of the hand-written
  CUDA kernel in ``csrc/topk.cu`` (a thread-block cluster per block): on
  a CUDA ``x`` it launches it (or raises) and counts the launch; on a CPU
  ``x`` it computes the plain version;
* ``blocked_topk_abs`` / ``blocked_topk_abs_plain`` — the whole function.
  The plain one selects with ``_select``. On a CUDA ``x`` the kernel path
  folds the selection into the same C call, a second launch behind the
  stage, where the k survivors fit one CTA's shared memory (every call of
  a sparse Transformer-base step but word_emb's); elsewhere it runs the
  stage and ``_select`` outside the kernel, as the JAX package selects
  outside its Pallas kernel. One launch counted per call either way.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import registry

__all__ = ["blocked_topk_abs", "blocked_topk_abs_plain", "blocked_topk_stage",
           "blocked_topk_stage_plain", "topk_abs_exact", "launch",
           "cluster_size", "scheduled_cluster",
           "DEFAULT_BLOCK"]

_SOURCE = "topk.cu"
DEFAULT_BLOCK = 131072
_PORTABLE_CLUSTER, _MAX_CLUSTER = 8, 16


def _checked(x, k, block):
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if not 1 <= int(k) <= x.shape[0]:
        raise ValueError(f"k = {k} outside [1, {x.shape[0]}]")
    if int(block) < 1:
        raise ValueError(f"block must be positive, got {block}")
    return int(k), int(block)


def _sort_desc(v):
    """Stable descending sort: ties keep index order (lower index first)."""
    return torch.sort(v, descending=True, stable=True)


def topk_abs_exact(x, k):
    """The top ``k`` of ``|x|`` over the whole vector: (values f32, indices
    int32), descending value, ties by lower index (``lax.top_k``'s
    order)."""
    vals, order = _sort_desc(x.abs().to(torch.float32))
    return vals[:k], order[:k].to(torch.int32)


def blocked_topk_stage_plain(x, k, block=DEFAULT_BLOCK):
    """Each ``block``-element block's top ``min(k, block)`` of ``|x|`` (pad
    lanes -1), in index order: (values [nb * kk] f32, indices [nb * kk]
    int32 global)."""
    k, block = _checked(x, k, block)
    n = x.shape[0]
    nb = -(-n // block)
    kk = min(k, block)
    padded = torch.full((nb * block,), -1.0, dtype=torch.float32,
                        device=x.device)
    padded[:n] = x.abs().to(torch.float32)
    rows = padded.view(nb, block)
    chosen = _sort_desc(rows)[1][:, :kk]
    chosen = torch.sort(chosen, dim=1).values          # back to index order
    vals = torch.gather(rows, 1, chosen)
    base = torch.arange(nb, device=x.device, dtype=torch.int64)[:, None] * block
    return vals.reshape(-1), (chosen + base).to(torch.int32).reshape(-1)


def cluster_size(block, blocks):
    """CTAs in the cluster that owns one ``block``-element block of a call
    over ``blocks`` blocks: one per 1024 elements, at most 8 (the portable
    size), or 16 where the call spans at most 8 blocks (at most 128 CTAs:
    a cluster of 16, where the card schedules one, halves each CTA's work,
    and more clusters than that queue for the GPCs)."""
    cap = _MAX_CLUSTER if blocks <= 8 else _PORTABLE_CLUSTER
    return min(cap, -(-int(block) // 1024))


class _Entry:
    """The C entry points, resolved once (declared argument types), and
    what the card decided per shape: the cluster size it schedules, and
    whether the selection fits a CTA."""

    def __init__(self):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.launch = build.function(_SOURCE, "blocked_topk_abs_f32",
                                     [i, p, p, p, p, p, ll, i, i, i, i, i, p])
        self.select_smem = build.function(_SOURCE, "blocked_topk_select_smem",
                                          [ll, i, i], ll)
        self.query_cluster = build.function(
            _SOURCE, "blocked_topk_cluster_size", [i, i, i, i])
        self.error_string = build.function(_SOURCE, "blocked_topk_error_string",
                                           [i], ctypes.c_char_p)
        self.stream = build.raw_stream_getter()
        self.clusters = {}      # (card, block, blocks) -> the stage's CTAs
        self.selects = {}       # (card, m, k) -> the selection's CTAs, or 0

    def _query(self, index, block, k_select, want):
        got = self.query_cluster(index, block, k_select, want)
        if got < 0:
            self.raise_on(-1 - got, "cluster size query")
        return got

    def cluster(self, index, block, blocks):
        """The stage's cluster size for ``blocks`` blocks of ``block`` on
        card ``index``: ``cluster_size``'s, or 8 where the card does not
        schedule a larger one."""
        key = (index, block, blocks)
        got = self.clusters.get(key)
        if got is None:
            got = self.clusters[key] = self._query(
                index, block, 0, cluster_size(block, blocks))
        return got

    def select_cluster(self, index, m, k):
        """The selection's cluster size over ``m`` candidates for ``k``
        survivors on card ``index`` (one block of ``m``), or 0 where the
        selection does not fit a CTA's shared memory."""
        key = (index, m, k)
        got = self.selects.get(key)
        if got is None:
            got = self._query(index, m, k, cluster_size(m, 1))
            if self.select_smem(m, k, got) < 0:
                got = 0
            self.selects[key] = got
        return got

    def raise_on(self, err, what):
        msg = self.error_string(err).decode()
        raise RuntimeError(f"blocked_topk_abs {what} failed: {msg} ({err})")


_entry = None


def scheduled_cluster(index, block, blocks):
    """The cluster size the stage launches with on card ``index`` for
    ``blocks`` blocks of ``block``."""
    return _lib().cluster(index, block, blocks)


def _lib():
    global _entry
    if _entry is None:
        _entry = _Entry()
    return _entry


def _shape(x, k, block):
    """(card index, n, nb, kk) of a launch; raises on what the kernel does
    not take."""
    index = x.get_device()
    if index < 0 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous float32 CUDA x")
    n = x.shape[0]
    nb = -(-n // block)
    if nb * block >= 2**31:
        raise ValueError("the kernel indexes x with int32")
    return index, n, nb, min(k, block)


def _launch(lib, index, x, cand_v, cand_i, out, n, block, nb, kk, k,
            select_cluster=0):
    out_v, out_i = out
    err = lib.launch(index, x.data_ptr(), cand_v, cand_i, out_v, out_i, n,
                     block, kk, k, lib.cluster(index, block, nb),
                     select_cluster, lib.stream(index))
    if err != 0:
        lib.raise_on(err, "kernel launch")
    registry.note_launch("blocked_topk_abs")


def launch(x, k, block=DEFAULT_BLOCK):
    """Launch K7's stage on a contiguous float32 CUDA ``x``, counting the
    launch. Returns the stage's (values, indices), as
    ``blocked_topk_stage_plain``."""
    return _stage(x, *_checked(x, k, block))


def _stage(x, k, block):
    index, n, nb, kk = _shape(x, k, block)
    vals = torch.empty(nb * kk, dtype=torch.float32, device=x.device)
    idx = torch.empty(nb * kk, dtype=torch.int32, device=x.device)
    _launch(_lib(), index, x, vals.data_ptr(), idx.data_ptr(), (None, None),
            n, block, nb, kk, k)
    return vals, idx


def _topk(x, k, block):
    """The whole blocked path on a contiguous float32 CUDA ``x`` (n > 2k,
    n > block): the stage, then the exact top ``k`` of its candidates. Where
    the k survivors fit one CTA's shared memory, one C call issues both
    (the stage's candidates in scratch); elsewhere the stage, then a stable
    sort of the candidates here. Counts one launch either way."""
    index, n, nb, kk = _shape(x, k, block)
    lib = _lib()
    m = nb * kk
    select_cluster = lib.select_cluster(index, m, k)
    if not select_cluster:
        return _select(*_stage(x, k, block), k)
    scratch = torch.empty(2 * m, dtype=torch.int32, device=x.device)
    vals = torch.empty(k, dtype=torch.float32, device=x.device)
    idx = torch.empty(k, dtype=torch.int32, device=x.device)
    cand = scratch.data_ptr()
    _launch(lib, index, x, cand, cand + 4 * m,
            (vals.data_ptr(), idx.data_ptr()), n, block, nb, kk, k,
            select_cluster)
    return vals, idx


def blocked_topk_stage(x, k, block=DEFAULT_BLOCK):
    """K7's wrapper: the per-block stage. CUDA ``x``: the kernel; CPU: the
    plain version."""
    if x.device.type != "cuda":
        return blocked_topk_stage_plain(x, k, block)
    return launch(x.to(torch.float32).contiguous(), k, block)


def _select(vals, idx, k):
    """The exact top ``k`` of the candidates, which lie in global index
    order: a stable descending sort breaks ties by lower index."""
    order = _sort_desc(vals)[1][:k]
    return vals[order], idx[order]


def _blocked(x, k, block, blocked):
    k, block = _checked(x, k, block)
    n = x.shape[0]
    if n <= 2 * k or n <= block:
        return topk_abs_exact(x, k)
    return blocked(x, k, block)


def _plain_blocked(x, k, block):
    return _select(*blocked_topk_stage_plain(x, k, block), k)


def _kernel_blocked(x, k, block):
    return _topk(x.to(torch.float32).contiguous(), k, block)


def blocked_topk_abs(x, k, block=DEFAULT_BLOCK):
    """(top ``k`` values of ``|x|``, their int32 indices) of a 1-D ``x``,
    exact, descending value, ties by lower index; the blocked path runs on
    K7 for a CUDA ``x``, on the plain version for a CPU one."""
    if x.device.type != "cuda":
        return blocked_topk_abs_plain(x, k, block)
    return _blocked(x, k, block, _kernel_blocked)


def blocked_topk_abs_plain(x, k, block=DEFAULT_BLOCK):
    """``blocked_topk_abs`` through the plain stage on any device."""
    return _blocked(x, k, block, _plain_blocked)
