"""Carry weights and training state into and out of the port by name.

The port's builders (``build_decoder_model``, ``build_bert_pretrain``) are
copies of the JAX package's, so both packages name every parameter and
optimizer accumulator the same way (``{name}_v{version}.l{i}.q.w``,
``word_embedding_moment1_0``, ``@LR_DECAY_COUNTER@``, ...). Arrays read
off the JAX package's scope by those names load into the port's scope as
they are, and the two packages then compute the same function;
``persistables_to_numpy`` reads a program's whole state back out.
"""

import numpy as np
import torch

__all__ = ["params_from_numpy", "load_params", "persistables_to_numpy"]


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
