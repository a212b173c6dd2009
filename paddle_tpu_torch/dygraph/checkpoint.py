"""save_dygraph / load_dygraph (reference: python/paddle/fluid/dygraph/
checkpoint.py — state-dict persistence), in the JAX package's file format,
so either package loads what the other saved: one .npz of arrays plus the
suffix conventions of the reference (.pdparams for layer state, .pdopt for
optimizer state)."""

import os

import numpy as np

from paddle_tpu_torch.utils.enforce import enforce


def _save_state(state_dict, path):
    arrays, meta = {}, {}
    for i, (name, val) in enumerate(state_dict.items()):
        key = f"arr_{i}"
        arrays[key] = np.asarray(val)
        meta[key] = name
    arrays["__names__"] = np.array(
        [meta[f"arr_{i}"] for i in range(len(meta))], dtype=object
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: v for k, v in arrays.items() if k != "__names__"},
             __names__=arrays["__names__"])


def _load_state(path):
    with np.load(path, allow_pickle=True) as data:
        names = list(data["__names__"])
        return {
            str(name): data[f"arr_{i}"] for i, name in enumerate(names)
        }


def save_dygraph(state_dict, model_path):
    """reference: python/paddle/fluid/dygraph/checkpoint.py save_dygraph."""
    enforce(bool(state_dict), "empty state_dict")
    # optimizer states carry non-array entries? normalize everything to arrays
    suffix = ".pdparams"
    for v in state_dict.values():
        if np.asarray(v).dtype == object:
            suffix = ".pdopt"
            break
    _save_state(state_dict, model_path + suffix + ".npz")


def load_dygraph(model_path):
    """Returns (param_state_dict, optimizer_state_dict) — either may be None
    (reference: checkpoint.py load_dygraph)."""
    params, opt = None, None
    p = model_path + ".pdparams.npz"
    if os.path.exists(p):
        params = _load_state(p)
    o = model_path + ".pdopt.npz"
    if os.path.exists(o):
        opt = _load_state(o)
    enforce(
        params is not None or opt is not None,
        f"no checkpoint found at {model_path}(.pdparams/.pdopt).npz",
    )
    return params, opt
