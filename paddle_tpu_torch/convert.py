"""Carry weights and training state into and out of the port by name.

The port's builders (``build_decoder_model``, ``build_bert_pretrain``) are
copies of the JAX package's, so both packages name every parameter and
optimizer accumulator the same way (``{name}_v{version}.l{i}.q.w``,
``word_embedding_moment1_0``, ``@LR_DECAY_COUNTER@``, ...). Arrays read
off the JAX package's scope by those names load into the port's scope as
they are, and the two packages then compute the same function;
``persistables_to_numpy`` reads a program's whole state back out. Under
AMP (``amp.decorate``) the parameters stay float32 master weights and the
dynamic loss-scaling state (``loss_scaling_*``, its good and bad step
counts) is persistables like any other, so both carry over the same way.

Data-parallel DGC state differs in layout: the JAX scope holds each
``dgc_momentum`` accumulator as one ``[n, ...]`` array over the mesh's n
shards, while each rank of the port holds its own ``[1, ...]`` slice.
``split_rank_state`` cuts the JAX arrays into the ranks' states and
``gather_rank_state`` puts the ranks' slices back together, so both
packages start from, and can be compared at, the same state.
"""

import numpy as np
import torch

__all__ = ["params_from_numpy", "load_params", "persistables_to_numpy",
           "dgc_state_names", "split_rank_state", "gather_rank_state"]


def params_from_numpy(arrays, device):
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``.
    Each tensor owns a copy of its array's bytes (never a view), so an
    in-place update in the port cannot reach the caller's array."""
    device = torch.device(device)
    return {name: torch.tensor(np.asarray(a), device=device)
            for name, a in arrays.items()}


def load_params(scope, arrays):
    """Overwrite ``scope``'s tensors with ``arrays`` by name, in the dtype
    and on the device of the tensor each replaces (run the startup
    program first). Raises on an unknown name or a shape mismatch."""
    for name, a in arrays.items():
        old = scope.find_var(name)
        if old is None:
            raise KeyError(f"scope holds no '{name}' (run the startup "
                           "program before loading weights)")
        a = np.asarray(a)
        if tuple(a.shape) != tuple(old.shape):
            raise ValueError(f"'{name}': array shape {a.shape} != scope "
                             f"shape {tuple(old.shape)}")
        scope.set(name, torch.tensor(a, dtype=old.dtype, device=old.device))


def persistables_to_numpy(scope, program):
    """``{name: np.ndarray}`` of every persistable var of ``program``'s
    global block that ``scope`` holds: parameters and, for a training
    program, the optimizer's moments and beta powers and the learning-rate
    step counter. Each array is a copy; ``load_params`` takes it back."""
    out = {}
    for v in program.global_block().vars.values():
        if v.persistable and scope.has_var(v.name):
            out[v.name] = scope.find_var(v.name).detach().cpu().numpy().copy()
    return out


def dgc_state_names(program):
    """The per-rank accumulators of ``program``: every ``dgc_momentum``
    op's U and V, sorted."""
    return sorted({name for op in program.global_block().ops
                   if op.type == "dgc_momentum"
                   for slot in ("U", "V") for name in op.input(slot)})


def split_rank_state(arrays, n, names):
    """``{name: array}`` of a JAX scope -> a list of n such dicts, one per
    rank: each array named in ``names`` (``[n, ...]``) gives rank r its
    ``[1, ...]`` slice ``[r:r+1]``; every other array goes to every rank
    as it is. Each array is a copy."""
    names = set(names)
    out = []
    for r in range(n):
        rank = {}
        for name, a in arrays.items():
            a = np.asarray(a)
            if name in names:
                if a.ndim == 0 or a.shape[0] != n:
                    raise ValueError(f"'{name}': shape {a.shape} has no "
                                     f"leading axis of {n} ranks")
                rank[name] = a[r:r + 1].copy()
            else:
                rank[name] = a.copy()
        out.append(rank)
    return out


def gather_rank_state(per_rank, names):
    """The inverse of ``split_rank_state``: the ranks' ``[1, ...]`` slices
    of each array named in ``names`` stacked in rank order into ``[n,
    ...]``; every other array from rank 0."""
    names = set(names)
    out = {}
    for name, a in per_rank[0].items():
        if name in names:
            out[name] = np.concatenate([np.asarray(r[name]) for r in per_rank])
        else:
            out[name] = np.asarray(a).copy()
    return out
