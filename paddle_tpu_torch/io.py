"""Model IO: save/load params, persistables, inference models, program state,
ported from the JAX package's ``io.py`` with the same files on disk.

reference: python/paddle/fluid/io.py — save_params :336, save_persistables
:556, save_inference_model :1022, load_inference_model :1229, program-state
save/load :1507,1565,1731. Persistence is host-side array serialization:
a `__model__` program file plus per-variable ``.npy`` files with a CRC
manifest (separate-files mode) or one combined ``.npz`` (save_combine
mode, reference: operators/save_combine_op.cc).

The files are the JAX package's: either package reads what the other
wrote, bit for bit. Scope values are torch tensors here; on the host they
are numpy arrays, and numpy has no bfloat16. A bfloat16 tensor goes to
the host as its raw 16-bit words in a 2-byte void array (``np.dtype("V2")``,
the dtype ``np.save`` gives the JAX package's ``ml_dtypes.bfloat16``
arrays, so the bytes and their CRC are the same); the combined format
stores those words as uint16 under its ``__bf16__`` tag, as the JAX
package does. Reading turns either back into ``torch.bfloat16`` with the
same bits. No other dtype the port holds is a 2-byte void.

Loads place tensors on ``executor.place``'s device; without an executor
they stay on the CPU and the executor moves them on first read.
``io.robust`` is the reader decorator (``reader/decorator.py``), as the
JAX package exposes it.
"""

import json
import os
import zlib

import numpy as np
import torch

from paddle_tpu_torch.core.ir import Parameter, Program, default_main_program
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.reader.decorator import robust  # noqa: F401  (fluid.io.robust)
from paddle_tpu_torch.utils.enforce import EnforceError, enforce

MODEL_FORMAT_VERSION = 1

#: the host form of a bfloat16 tensor: its raw 16-bit words
BF16_HOST = np.dtype("V2")


def to_host(value):
    """A host numpy copy of a scope value (a torch tensor or an array);
    bfloat16 becomes its raw words as ``BF16_HOST``. Never a view of the
    value: an in-place update after the call cannot reach the copy."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            return to_host(t.view(torch.int16)).view(BF16_HOST)
        if t.device.type == "cpu":
            t = t.clone()
        return t.cpu().numpy()
    return np.array(value)


def to_tensor(arr, device=None):
    """A torch tensor of a host array on ``device`` (default the CPU):
    ``BF16_HOST`` becomes ``torch.bfloat16`` with the same bits. A CPU
    result shares the array's memory (callers hand over arrays they read
    from disk and own)."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if arr.dtype == BF16_HOST:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(torch.device("cpu") if device is None else device)


def dtype_name(arr):
    """The dtype a manifest records for a host array (``bfloat16`` for
    ``BF16_HOST``, as the JAX package writes for its bf16 arrays)."""
    return "bfloat16" if arr.dtype == BF16_HOST else str(arr.dtype)


def array_crc32(arr):
    """Integrity checksum of an array's payload bytes (dtype-agnostic —
    bf16 words included); the unit of verification for checkpoint
    manifests (incubate/checkpoint.py) and separate-files saves below.
    The JAX package's value for the same bytes."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    return zlib.crc32(flat.view(np.uint8)) & 0xFFFFFFFF


def _is_persistable(var):
    return var.persistable and not var.is_data


def _is_parameter(var):
    return isinstance(var, Parameter)


def _device(executor):
    return None if executor is None else executor.place.device


def _gather_vars(program, predicate, scope):
    out = {}
    for var in program.global_block().vars.values():
        if not predicate(var):
            continue
        val = scope.find_var(var.name)
        if val is None:
            raise EnforceError(
                f"variable {var.name} is not initialized in scope; run the "
                f"startup program before saving"
            )
        out[var.name] = to_host(val)
    return out


def _write_combined(path, arrays):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = sorted(arrays)
    payload = {}
    bf16_names = []
    for i, n in enumerate(names):
        a = np.asarray(arrays[n])
        if a.dtype == BF16_HOST:
            # numpy's npz format can't represent bfloat16; store the raw
            # bits as uint16 + a tag, as the JAX package does
            a = a.view(np.uint16)
            bf16_names.append(n)
        payload[f"arr_{i}"] = a
    np.savez(
        path,
        __names__=np.array(names, dtype=object),
        __bf16__=np.array(bf16_names, dtype=object),
        **payload,
    )


def _read_combined(path):
    """``{name: host array}`` of a combined file (bf16 as ``BF16_HOST``)."""
    real = path if os.path.exists(path) else path + ".npz"
    enforce(os.path.exists(real), f"params file {path} not found")
    with np.load(real, allow_pickle=True) as data:
        names = [str(n) for n in data["__names__"]]
        bf16 = (
            {str(n) for n in data["__bf16__"]} if "__bf16__" in data else set()
        )
        out = {}
        for i, n in enumerate(names):
            a = data[f"arr_{i}"]
            if n in bf16:
                a = a.view(BF16_HOST)
            out[n] = a
        return out


# ---------------------------------------------------------------------------
# save/load params + persistables (reference: io.py:336,556,744,802)
# ---------------------------------------------------------------------------


def save_vars(executor, dirname, main_program=None, predicate=None, filename=None, vars=None):
    program = main_program or default_main_program()
    scope = global_scope()
    if vars is not None:
        arrays = {}
        for v in vars:
            name = v if isinstance(v, str) else v.name
            val = scope.find_var(name)
            enforce(val is not None, f"variable {name} not in scope")
            arrays[name] = to_host(val)
    else:
        arrays = _gather_vars(program, predicate or _is_persistable, scope)
    if filename is None:
        os.makedirs(dirname, exist_ok=True)
        for name, arr in arrays.items():
            np.save(os.path.join(dirname, name.replace("/", "_")) + ".npy", arr)
        manifest = {
            "format_version": MODEL_FORMAT_VERSION,
            "vars": sorted(arrays),
            # per-var payload CRCs: load_vars verifies these, so a torn
            # or bit-rotted .npy fails loudly naming the variable
            "crc32": {n: array_crc32(a) for n, a in arrays.items()},
        }
        with open(os.path.join(dirname, "__manifest__.json"), "w") as f:
            json.dump(manifest, f)
    else:
        _write_combined(os.path.join(dirname, filename), arrays)
    return sorted(arrays)


def load_vars(executor, dirname, main_program=None, predicate=None, filename=None, vars=None):
    program = main_program or default_main_program()
    scope = global_scope()
    device = _device(executor)
    if vars is not None:
        names = [v if isinstance(v, str) else v.name for v in vars]
    else:
        names = [
            v.name
            for v in program.global_block().vars.values()
            if (predicate or _is_persistable)(v)
        ]
    if filename is None:
        crcs = {}
        man_p = os.path.join(dirname, "__manifest__.json")
        if os.path.exists(man_p):
            try:
                with open(man_p) as f:
                    crcs = json.load(f).get("crc32", {})
            except (ValueError, json.JSONDecodeError) as e:
                raise EnforceError(f"corrupt manifest {man_p}: {e}")
        for name in names:
            path = os.path.join(dirname, name.replace("/", "_")) + ".npy"
            enforce(os.path.exists(path), f"no saved file for variable {name}")
            arr = np.load(path)
            if name in crcs:
                crc = array_crc32(arr)
                enforce(
                    crc == crcs[name],
                    f"variable {name} is corrupt: CRC {crc:#x} != saved "
                    f"{crcs[name]:#x} ({path})",
                )
            scope.set(name, to_tensor(arr, device))
    else:
        arrays = _read_combined(os.path.join(dirname, filename))
        missing = [n for n in names if n not in arrays]
        enforce(not missing, f"saved file is missing variables {missing[:5]}")
        for name in names:
            scope.set(name, to_tensor(arrays[name], device))
    return names


def save_params(executor, dirname, main_program=None, filename=None):
    """reference: python/paddle/fluid/io.py:336."""
    return save_vars(executor, dirname, main_program, _is_parameter, filename)


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, _is_parameter, filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Includes optimizer accumulators — they are persistable vars
    (reference: python/paddle/fluid/io.py:556)."""
    return save_vars(executor, dirname, main_program, _is_persistable, filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, _is_persistable, filename)


# ---------------------------------------------------------------------------
# unified save/load (reference: io.py:1507 save, :1565 load)
# ---------------------------------------------------------------------------


def save(program, model_path):
    scope = global_scope()
    params = _gather_vars(program, _is_parameter, scope)
    _write_combined(model_path + ".pdparams", params)
    others = {
        n: a
        for n, a in _gather_vars(program, _is_persistable, scope).items()
        if n not in params
    }
    _write_combined(model_path + ".pdopt", others)


def load(program, model_path, executor=None):
    scope = global_scope()
    device = _device(executor)
    arrays = _read_combined(model_path + ".pdparams")
    arrays.update(_read_combined(model_path + ".pdopt"))
    for var in program.global_block().vars.values():
        if _is_persistable(var) and var.name in arrays:
            scope.set(var.name, to_tensor(arrays[var.name], device))


def load_program_state(model_path):
    """reference: io.py:1731 — returns name -> CPU torch tensor for
    partial/transfer loading."""
    state = _read_combined(model_path + ".pdparams")
    opt_path = model_path + ".pdopt"
    if os.path.exists(opt_path) or os.path.exists(opt_path + ".npz"):
        state.update(_read_combined(opt_path))
    return {n: to_tensor(a) for n, a in state.items()}


def set_program_state(program, state):
    """Set each var of ``program`` that ``state`` names (torch tensors or
    numpy arrays, copied onto the CPU) in the global scope; returns the
    names used."""
    scope = global_scope()
    used = set()
    for var in program.global_block().vars.values():
        if var.name in state:
            v = state[var.name]
            t = (v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                 else to_tensor(np.array(v)))
            scope.set(var.name, t)
            used.add(var.name)
    return sorted(used)


# ---------------------------------------------------------------------------
# inference model export (reference: io.py:1022,1229)
# ---------------------------------------------------------------------------


def save_inference_model(
    dirname,
    feeded_var_names,
    target_vars,
    executor,
    main_program=None,
    model_filename=None,
    params_filename=None,
):
    """Prune to the feed→fetch subgraph, strip train-only behavior, save
    program + params (reference: python/paddle/fluid/io.py:1022)."""
    program = main_program or default_main_program()
    infer = program.clone(for_test=True)
    target_names = [t if isinstance(t, str) else t.name for t in target_vars]
    infer._prune(target_names)

    # verify the pruned program is well-formed and the feeds suffice for the
    # targets before anything touches disk — a saved-then-broken model fails
    # here with op attribution, not at load/serve time
    from paddle_tpu_torch.analysis.verify import verify_program

    errors = [
        d for d in verify_program(
            infer, feed_names=feeded_var_names, fetch_names=target_names,
        )
        if d.severity == "error"
    ]
    enforce(
        not errors,
        "inference program failed verification:\n"
        + "\n".join(str(d) for d in errors),
    )

    infer._attrs["feed_var_names"] = list(feeded_var_names)
    infer._attrs["fetch_var_names"] = target_names

    os.makedirs(dirname, exist_ok=True)
    model_path = os.path.join(dirname, model_filename or "__model__")
    desc = infer.desc()
    desc["feed_var_names"] = list(feeded_var_names)
    desc["fetch_var_names"] = target_names
    with open(model_path, "wb") as f:
        f.write(json.dumps(desc, sort_keys=True).encode("utf-8"))

    scope = global_scope()
    arrays = {}
    for var in infer.global_block().vars.values():
        if var.persistable and not var.is_data:
            val = scope.find_var(var.name)
            if val is not None:
                arrays[var.name] = to_host(val)
    _write_combined(
        os.path.join(dirname, params_filename or "__params__"), arrays
    )
    return target_names


def load_inference_model(
    dirname, executor, model_filename=None, params_filename=None
):
    """Returns (program, feed_names, fetch_vars); the parameters land in
    the global scope on ``executor``'s device
    (reference: python/paddle/fluid/io.py:1229)."""
    model_path = os.path.join(dirname, model_filename or "__model__")
    enforce(os.path.exists(model_path), f"{model_path} not found")
    with open(model_path, "rb") as f:
        desc = json.loads(f.read().decode("utf-8"))
    program = Program.from_bytes(
        json.dumps({k: v for k, v in desc.items() if k not in ("feed_var_names", "fetch_var_names")}).encode()
    )
    feed_names = desc.get("feed_var_names", [])
    fetch_names = desc.get("fetch_var_names", [])
    arrays = _read_combined(os.path.join(dirname, params_filename or "__params__"))
    scope = global_scope()
    device = _device(executor)
    for name, arr in arrays.items():
        scope.set(name, to_tensor(arr, device))
    block = program.global_block()
    fetch_vars = [block.var(n) for n in fetch_names]
    return program, feed_names, fetch_vars


# ---------------------------------------------------------------------------
# train-model export (reference: paddle/fluid/train/ — demo_trainer.cc
# loads serialized main/startup ProgramDescs and trains without Python)
# ---------------------------------------------------------------------------


def save_train_model(dirname, main_program, startup_program, loss=None,
                     executor=None):
    """Serialize (main, startup) programs + meta so another process can
    train. With `executor`, current persistables are saved too (warm
    start); otherwise the loader runs the startup program."""
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "main_program"), "wb") as f:
        f.write(main_program.to_bytes())
    with open(os.path.join(dirname, "startup_program"), "wb") as f:
        f.write(startup_program.to_bytes())
    meta = {"format_version": MODEL_FORMAT_VERSION}
    if loss is not None:
        meta["loss"] = loss if isinstance(loss, str) else loss.name
    with open(os.path.join(dirname, "meta.json"), "w") as f:
        json.dump(meta, f)
    if executor is not None:
        save_persistables(
            executor, os.path.join(dirname, "params"),
            main_program=main_program,
        )


def load_train_model(dirname):
    """Returns (main_program, startup_program, loss_name_or_None)."""
    with open(os.path.join(dirname, "main_program"), "rb") as f:
        main = Program.from_bytes(f.read())
    with open(os.path.join(dirname, "startup_program"), "rb") as f:
        startup = Program.from_bytes(f.read())
    loss = None
    meta_p = os.path.join(dirname, "meta.json")
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            loss = json.load(f).get("loss")
    return main, startup, loss
