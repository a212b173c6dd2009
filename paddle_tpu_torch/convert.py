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

Dygraph state crosses as the JAX package's ``Layer.state_dict()`` makes
it, numpy arrays by parameter and buffer name: ``load_layer_state`` puts
such a dict into a port ``Layer`` (by name, or by order where the two
models were built with other names), and a port ``Layer``'s
``state_dict()`` is such a dict for the JAX ``Layer.set_dict``.
``transformer_params`` reads a Transformer's weights off a JAX scope (or
any ``{name: array}``) into the dict the port's beam decoder takes
(``models/transformer.py`` ``params_from_scope``).

A hybrid-parallel program's parameters (``models/gpt_ir.py``: the
stacked ``[L, ...]`` layers of its ``pipeline_stack``) cross as the JAX
package's global arrays (``gpt_ir_params``); ``shard_params`` cuts them
into the shard a rank holds at its mesh coordinates, by the specs its
``CompiledProgram`` places them with (``CompiledProgram.specs``), so a
rank's scope can be loaded with its shard directly.
"""

import numpy as np
import torch

__all__ = ["params_from_numpy", "load_params", "persistables_to_numpy",
           "dgc_state_names", "split_rank_state", "gather_rank_state",
           "load_layer_state", "transformer_params", "gpt_ir_params",
           "shard_params"]


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


def load_layer_state(layer, state, by_order=False):
    """Put a dygraph ``state_dict`` (``{name: array}``, the JAX package's
    ``Layer.state_dict()`` or the port's) into the port ``layer``'s
    parameters and buffers, on their device and in their dtype. By name,
    or with ``by_order`` matched to ``layer.state_dict()``'s order (two
    models built with other names); raises if a parameter is missing."""
    if by_order:
        names = list(layer.state_dict())
        if len(names) != len(state):
            raise ValueError(f"state holds {len(state)} arrays, the layer "
                             f"{len(names)}")
        state = dict(zip(names, state.values()))
    layer.set_dict({n: np.asarray(a) for n, a in state.items()})


def transformer_params(source, cfg, device="cpu"):
    """The Transformer weights the port's beam decoder reads
    (``models.transformer.param_names(cfg)``), from ``source`` — a scope
    of either package, or ``{name: array}`` — as ``{name: tensor}`` on
    ``device``."""
    from paddle_tpu_torch.models.transformer import param_names

    get = source.find_var if hasattr(source, "find_var") else source.__getitem__
    arrays = {}
    for n in param_names(cfg):
        v = get(n)
        if v is None:
            raise KeyError(f"'{n}' not found (run the startup program first)")
        arrays[n] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v))
    return params_from_numpy(arrays, device)


def gpt_ir_params(source, program):
    """``{name: global numpy array}`` of ``program``'s parameters (a
    ``models/gpt_ir.py`` program: the stacked layers ``[L, ...]``) read
    off a JAX scope or any ``{name: array}``: the names are the same in
    both packages."""
    get = source.find_var if hasattr(source, "find_var") else source.__getitem__
    return {p.name: np.asarray(get(p.name)) for p in program.all_parameters()}


def shard_params(arrays, specs, mesh, coords=None):
    """``{name: global array}`` -> the shards a rank holds under ``specs``
    (``{name: PartitionSpec}``) at ``coords`` (``{axis: index}``; default
    this process's place on ``mesh``). A name without a spec is
    replicated."""
    from paddle_tpu_torch.parallel.sharding import shard_of

    return {n: np.ascontiguousarray(shard_of(np.asarray(a), specs.get(n, ()),
                                             mesh, coords))
            for n, a in arrays.items()}
