"""Automatic checkpoint + resume, ported from the JAX package's
``incubate/checkpoint.py`` with the same directories on disk: either
package verifies and loads what the other wrote.

The reference's recovery is checkpoint-based: jobs restart from the last
save (reference: python/paddle/fluid/io.py:405 _save_distributed
_persistables). The unit of recovery is (persistable state + step
counter): ``save`` snapshots the scope on the training thread (one copy
per tensor into pinned host memory and one synchronize for the card's
tensors, a clone for the CPU's: the executor and ``sgd_sparse`` update
tensors in place, so a snapshot is never a view) and writes the files
on a background thread, with an atomic ``latest`` pointer, plus
``resume()`` on restart.

Crash consistency (the CheckFreq/Check-N-Run recipe): every checkpoint
directory carries a manifest with a CRC32 per array AND of the state
file itself, written BEFORE the atomic rename — so a torn write, a bad
disk, or a fault-injected corruption is DETECTED at resume time instead
of silently loading garbage. `resume()` verifies the `latest` target and
walks back the checkpoint chain past corrupt/torn entries, quarantining
them as `<name>.corrupt` for forensics. File IO runs under the shared
retry policy (resilience/retry.py), and the write path fires the fault
sites `checkpoint.io`, `checkpoint.before_rename` and
`checkpoint.before_latest` (the port's ``resilience/faults.py``).

Sharded checkpoints (manifest format 2): a state provider's arrays
(``extra_state.checkpoint_arrays()``, e.g. the embedding engine's host
tier) may come as per-shard blocks (``_ShardSnap``), each written to the
host's ``shards_p<process>.npz`` with its slice bounds and CRC32 in the
manifest; a corrupt SHARD walks the chain back exactly like a corrupt
array, and ``ShardedArray`` stitches any slice from the stored blocks.
No scope tensor of the port is sharded, so scope values always take the
format-1 path; the JAX package's ``load_checkpoint(shardings=)`` restore
onto a device mesh needs ROADMAP M11 and raises here.

bfloat16 persistables: the JAX package writes them into ``state.npz`` as
2-byte void arrays (``np.savez`` of ``ml_dtypes.bfloat16``) under a
manifest dtype of ``bfloat16``, and its own ``load_checkpoint`` then puts
the void array into the scope, which its executor refuses. The port
writes its bf16 tensors the same way and reads such an entry (its void
array is ``io.BF16_HOST``) as ``torch.bfloat16`` with the same bits.

Restored values are torch tensors of the manifest's dtype: on the CPU
from ``load_checkpoint`` (the executor moves them on first read), on the
executor's device from ``AutoCheckpoint.resume``.

``HeartBeatMonitor`` is the JAX package's chief-side worker-lost
detection over the parameter server's heartbeat table (its lock is the
lockdep class ``resilience.heartbeat``, as there).

Lock order (declared to the lockdep witness, as in the JAX package): the
checkpoint writer-state lock comes before the embedding engine's host
tier and pending-marker locks it snapshots through
``extra_state.checkpoint_arrays()`` ("checkpoint.manifest" ->
"embedding.table" -> "embedding.pending"); nothing holds the writer-state
lock across the flush itself.
"""

import contextlib
import io as _io
import json
import logging
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.dataio.state import STATE_KEY, decode_state, encode_state
from paddle_tpu_torch.io import BF16_HOST, array_crc32, dtype_name, to_host, to_tensor
from paddle_tpu_torch.observability import lockdep
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.retry import RetryPolicy

# the writer-state lock is ABOVE the sharded stores it snapshots through
# extra_state.checkpoint_arrays() (the embedding host tier and its
# pending-marker map); it is never held across the flush itself
lockdep.declare_order("checkpoint.manifest", "embedding.table",
                      "embedding.pending")

__all__ = [
    "AutoCheckpoint",
    "CheckpointCorruptError",
    "ShardedArray",
    "snapshot_value",
    "verify_checkpoint",
    "newest_valid_checkpoint",
    "load_checkpoint",
    "load_data_state",
    "gang_generations",
    "GANG_GENERATION_ENV",
    "HeartBeatMonitor",
]

log = logging.getLogger("paddle_tpu_torch.checkpoint")

MANIFEST_NAME = "manifest.json"
# A monotonically increasing gang-generation counter an elastic supervisor
# injects, stamped into every manifest + meta.json this process writes so
# the checkpoint chain records WHICH gang incarnation produced each entry.
GANG_GENERATION_ENV = "PADDLE_ELASTIC_GANG_GENERATION"
_DEFAULT_IO_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.02,
                                max_delay_s=0.5)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed integrity verification."""


@contextlib.contextmanager
def _timed(timings, key):
    """Add the seconds of the block to ``timings[key]`` (no-op for None)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def _np_dtype(name):
    return BF16_HOST if name == "bfloat16" else np.dtype(name)


# ---------------------------------------------------------------------------
# snapshots and sharded values (manifest format 2)
# ---------------------------------------------------------------------------


class _ShardSnap:
    """Save-side snapshot of a value held as per-shard host blocks (a
    state provider's output): the whole array never materializes."""

    __slots__ = ("shape", "dtype", "spec", "blocks")

    def __init__(self, shape, dtype, spec, blocks):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = str(dtype)
        self.spec = spec
        self.blocks = blocks  # [(start tuple, stop tuple, np.ndarray)]


def snapshot_value(value):
    """A host numpy copy of one scope value (bfloat16 as its raw words):
    never a view, so a later in-place update cannot reach it."""
    return to_host(value)


def _snapshot(values):
    """``{name: host copy}`` of ``{name: value}``: each card tensor is
    copied once into pinned host memory, with one synchronize per card
    after all the copies; CPU tensors are cloned."""
    pinned, out, cards = {}, {}, set()
    for n, v in values.items():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v.detach(), non_blocking=True)
            pinned[n] = buf
            cards.add(v.device)
        else:
            out[n] = snapshot_value(v)
    for dev in cards:
        torch.cuda.synchronize(dev)
    for n, buf in pinned.items():
        if buf.dtype == torch.bfloat16:
            out[n] = buf.view(torch.int16).numpy().view(BF16_HOST)
        else:
            out[n] = buf.numpy()
    return {n: out[n] for n in values}


class ShardedArray:
    """Load-side view over verified shard blocks: assembles the full array
    on demand, or any [start, stop) box of it (``read_slice``). The JAX
    package's ``to_jax`` rebuild onto a device mesh has no counterpart
    yet (ROADMAP M11)."""

    __slots__ = ("name", "shape", "dtype", "spec", "blocks")

    def __init__(self, name, shape, dtype, spec, blocks):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = _np_dtype(str(dtype))
        self.spec = spec
        self.blocks = blocks

    def read_slice(self, start, stop):
        """Stitch an arbitrary [start, stop) box from the stored blocks;
        incomplete coverage is corruption (a missing shard)."""
        out_shape = tuple(e - s for s, e in zip(start, stop))
        out = np.empty(out_shape, self.dtype)
        covered = 0
        for bstart, bstop, data in self.blocks:
            lo = tuple(max(s, bs) for s, bs in zip(start, bstart))
            hi = tuple(min(e, be) for e, be in zip(stop, bstop))
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            dst = tuple(
                slice(l - s, h - s) for l, h, s in zip(lo, hi, start)
            )
            src = tuple(
                slice(l - bs, h - bs) for l, h, bs in zip(lo, hi, bstart)
            )
            out[dst] = data[src]
            n = 1
            for l, h in zip(lo, hi):
                n *= h - l
            covered += n
        want = 1
        for d in out_shape:
            want *= d
        if covered < want:
            raise CheckpointCorruptError(
                f"sharded array '{self.name}': slice {start}..{stop} only "
                f"{covered}/{want} elements covered by stored shards"
            )
        return out

    def assemble(self):
        return self.read_slice((0,) * len(self.shape), self.shape)


def _shard_key(name, i):
    return f"{name}::{i}"


def _process_index():
    """This process's rank in ``torch.distributed`` (0 when it is not
    initialized)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _process_count():
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _fsynced_write(path, raw, timings=None):
    with open(path, "wb") as f:
        with _timed(timings, "write_s"):
            f.write(raw)
            f.flush()
        with _timed(timings, "fsync_s"):
            os.fsync(f.fileno())


def _write_shard_file(tmp, sharded, pid, write_index, timings=None):
    """Write one host's ``shards_p<pid>.npz`` (+ fsync) and, for
    non-chief hosts, the ``shards_p<pid>.index.json`` sidecar the chief
    merges into the manifest: {file: {size, crc32}, sharded: {name:
    {dtype, shape, spec, shards: [...]}}}. Returns (files_entry,
    sharded_entries) for the caller's own bookkeeping."""
    shard_file = f"shards_p{pid}.npz"
    entries = {}
    sharded_entries = {}
    for n, s in sharded.items():
        shard_list = []
        for i, (start, stop, data) in enumerate(s.blocks):
            key = _shard_key(n, i) + f"@p{pid}"
            entries[key] = data
            with _timed(timings, "crc_s"):
                crc = array_crc32(data)
            shard_list.append({
                "file": shard_file,
                "key": key,
                "start": list(start),
                "stop": list(stop),
                "crc32": crc,
                "nbytes": int(data.nbytes),
            })
        sharded_entries[n] = {
            "dtype": s.dtype,
            "shape": list(s.shape),
            "spec": s.spec,
            "shards": shard_list,
        }
    files_entry = {}
    if entries:
        with _timed(timings, "serialize_s"):
            sbuf = _io.BytesIO()
            np.savez(sbuf, **entries)
            sraw = sbuf.getvalue()
        _fsynced_write(os.path.join(tmp, shard_file), sraw, timings)
        with _timed(timings, "crc_s"):
            files_entry[shard_file] = {
                "size": len(sraw),
                "crc32": zlib.crc32(sraw) & 0xFFFFFFFF,
            }
    if write_index:
        # the index commits via atomic rename: the chief's merge poll
        # must never read a half-written json
        idx = {"files": files_entry, "sharded": sharded_entries}
        ipath = os.path.join(tmp, f"shards_p{pid}.index.json")
        with open(ipath + ".tmp", "w") as f:
            json.dump(idx, f)
        os.replace(ipath + ".tmp", ipath)
    return files_entry, sharded_entries


def _merge_host_indices(tmp, world, files, sharded_manifest,
                        timeout=None):
    """Chief-side merge: fold every non-chief host's shard index into the
    manifest, so the manifest names EVERY host's shard file and blocks. A
    host whose index never appears raises — the save fails loudly instead
    of committing a manifest that silently thins coverage."""
    if timeout is None:
        timeout = float(os.environ.get("PADDLE_TPU_CKPT_MERGE_TIMEOUT",
                                       "120"))
    deadline = time.monotonic() + timeout
    for k in range(1, world):
        ipath = os.path.join(tmp, f"shards_p{k}.index.json")
        idx = None
        while idx is None:
            if os.path.exists(ipath):
                with open(ipath) as f:
                    candidate = json.load(f)
                # the sidecar must describe the npz bytes ON DISK — a
                # stale index from a crashed earlier attempt mismatches
                # and keeps polling until the host republishes
                ok = True
                for fname, finfo in candidate.get("files", {}).items():
                    fpath = os.path.join(tmp, fname)
                    if (not os.path.exists(fpath)
                            or os.path.getsize(fpath) != finfo["size"]):
                        ok = False
                        break
                    with open(fpath, "rb") as f:
                        crc = zlib.crc32(f.read()) & 0xFFFFFFFF
                    if crc != finfo["crc32"]:
                        ok = False
                        break
                if ok:
                    idx = candidate
                    break
            if time.monotonic() > deadline:
                raise CheckpointCorruptError(
                    f"multi-host checkpoint: host {k}/{world} never "
                    f"published a consistent "
                    f"{os.path.basename(ipath)} within {timeout:.0f}s "
                    "— refusing to commit a manifest with thinned "
                    "shard coverage"
                )
            time.sleep(0.05)
        files.update(idx.get("files", {}))
        for name, info in idx.get("sharded", {}).items():
            cur = sharded_manifest.get(name)
            if cur is None:
                sharded_manifest[name] = {
                    "dtype": info["dtype"],
                    "shape": list(info["shape"]),
                    "spec": info.get("spec"),
                    "shards": list(info["shards"]),
                }
                continue
            if (cur["dtype"] != info["dtype"]
                    or list(cur["shape"]) != list(info["shape"])):
                raise CheckpointCorruptError(
                    f"multi-host checkpoint: host {k} disagrees on "
                    f"'{name}' ({info['dtype']}{info['shape']} vs "
                    f"{cur['dtype']}{cur['shape']})"
                )
            cur["shards"].extend(info["shards"])
        # the sidecar stays on disk here — a retried write_files must be
        # able to re-read it; the caller removes sidecars after the whole
        # protocol succeeds


def _ckpt_step(name):
    tail = name.split("_", 1)[1] if "_" in name else ""
    return int(tail) if tail.isdigit() else None


def verify_checkpoint(dirname, level="full", assemble=True, timings=None):
    """Integrity-check one checkpoint directory; returns (step, arrays)
    — arrays is None at level="file" — or raises CheckpointCorruptError
    naming exactly what is wrong.

    Checks, outside-in: meta/state files present -> whole-file CRC +
    size for EVERY manifest-listed file (state.npz and any
    shards_p*.npz) -> (level="full" only) npz readable -> per-array and
    per-shard CRC32. Each file is read ONCE; arrays are parsed from the
    same bytes the CRC covered. level="file" stops after the whole-file
    checks. Pre-manifest (legacy) checkpoints pass on readability alone.
    An entry the manifest records as ``bfloat16`` is a 2-byte void array
    in the file (both packages write it so), which is ``io.BF16_HOST``.

    ``assemble=False`` returns format-2 sharded entries as
    ``ShardedArray`` views (shard blocks CRC-verified, full array NOT
    materialized); the default assembles everything to numpy.
    ``timings`` (a dict) collects the seconds of ``read_s``,
    ``file_crc_s``, ``parse_s`` and ``array_crc_s`` and the ``bytes``
    read."""
    state_p = os.path.join(dirname, "state.npz")
    meta_p = os.path.join(dirname, "meta.json")
    man_p = os.path.join(dirname, MANIFEST_NAME)
    for p in (state_p, meta_p):
        if not os.path.exists(p):
            raise CheckpointCorruptError(f"{dirname}: missing {os.path.basename(p)}")
    try:
        with open(meta_p) as f:
            meta = json.load(f)
        step = int(meta["step"])
    except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"{dirname}: bad meta.json ({e})")
    manifest = None
    file_bytes = {}  # fname -> raw bytes (only files the manifest CRCs)
    if os.path.exists(man_p):
        try:
            with open(man_p) as f:
                manifest = json.load(f)
        except (ValueError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(f"{dirname}: bad manifest ({e})")
        for fname, finfo in manifest.get("files", {}).items():
            fpath = os.path.join(dirname, fname)
            if not os.path.exists(fpath):
                raise CheckpointCorruptError(
                    f"{dirname}: missing {fname} (manifest lists it)"
                )
            size = os.path.getsize(fpath)
            if "size" in finfo and size != finfo["size"]:
                raise CheckpointCorruptError(
                    f"{dirname}: {fname} is {size} bytes, manifest says "
                    f"{finfo['size']} (torn write)"
                )
            if "crc32" in finfo:
                with _timed(timings, "read_s"):
                    with open(fpath, "rb") as f:
                        raw = f.read()
                if timings is not None:
                    timings["bytes"] = timings.get("bytes", 0) + len(raw)
                with _timed(timings, "file_crc_s"):
                    crc = zlib.crc32(raw) & 0xFFFFFFFF
                if crc != finfo["crc32"]:
                    raise CheckpointCorruptError(
                        f"{dirname}: {fname} CRC {crc:#x} != manifest "
                        f"{finfo['crc32']:#x}"
                    )
                file_bytes[fname] = raw
    if level == "file":
        return step, None
    arrays = {}
    raw = file_bytes.get("state.npz")
    try:
        with _timed(timings, "parse_s"):
            with np.load(_io.BytesIO(raw) if raw is not None else state_p) as z:
                for n in z.files:
                    arrays[n] = z[n]
    except Exception as e:
        raise CheckpointCorruptError(f"{dirname}: unreadable state.npz ({e})")
    if manifest is not None:
        want = manifest.get("arrays", {})
        missing = sorted(set(want) - set(arrays))
        if missing:
            raise CheckpointCorruptError(
                f"{dirname}: arrays missing from state.npz: {missing[:5]}"
            )
        for n, info in want.items():
            with _timed(timings, "array_crc_s"):
                crc = array_crc32(arrays[n])
            if crc != info["crc32"]:
                raise CheckpointCorruptError(
                    f"{dirname}: array '{n}' CRC {crc:#x} != manifest "
                    f"{info['crc32']:#x}"
                )
        # format-2 sharded entries: load each shard file once, CRC every
        # block, and hand back ShardedArray views (or assembled numpy).
        # finally-close so a CRC/coverage failure mid-walk-back does not
        # leak open npz handles
        shard_zips = {}
        try:
            for name, info in manifest.get("sharded", {}).items():
                blocks = []
                for i, sh in enumerate(info.get("shards", [])):
                    fname = sh["file"]
                    z = shard_zips.get(fname)
                    if z is None:
                        braw = file_bytes.get(fname)
                        fpath = os.path.join(dirname, fname)
                        try:
                            z = np.load(
                                _io.BytesIO(braw) if braw is not None
                                else fpath
                            )
                        except Exception as e:
                            raise CheckpointCorruptError(
                                f"{dirname}: unreadable {fname} ({e})"
                            )
                        shard_zips[fname] = z
                    key = sh.get("key", _shard_key(name, i))
                    if key not in z.files:
                        raise CheckpointCorruptError(
                            f"{dirname}: shard '{key}' missing from {fname}"
                        )
                    with _timed(timings, "parse_s"):
                        data = z[key]
                    with _timed(timings, "array_crc_s"):
                        crc = array_crc32(data)
                    if crc != sh["crc32"]:
                        raise CheckpointCorruptError(
                            f"{dirname}: shard '{key}' CRC {crc:#x} != "
                            f"manifest {sh['crc32']:#x}"
                        )
                    blocks.append(
                        (tuple(sh["start"]), tuple(sh["stop"]), data)
                    )
                total = sum(int(np.prod(b[2].shape)) for b in blocks)
                want = int(np.prod(info["shape"])) if info["shape"] else 1
                if total != want:
                    raise CheckpointCorruptError(
                        f"{dirname}: sharded array '{name}' blocks cover "
                        f"{total}/{want} elements"
                    )
                view = ShardedArray(
                    name, info["shape"], info["dtype"], info.get("spec"),
                    blocks,
                )
                if assemble:
                    arrays[name] = view.assemble()
                else:
                    arrays[name] = view
        finally:
            for z in shard_zips.values():
                z.close()
    return step, arrays


def _quarantine(dirname, reason):
    """Rename a corrupt checkpoint out of the chain (never delete — a
    human may want the bytes). Idempotent against name collisions."""
    target = dirname + ".corrupt"
    n = 0
    while os.path.exists(target):
        n += 1
        target = f"{dirname}.corrupt{n}"
    try:
        os.replace(dirname, target)
        log.error("quarantined corrupt checkpoint %s -> %s (%s)",
                  dirname, target, reason)
    except OSError as e:
        log.error("could not quarantine %s: %s", dirname, e)
    return target


def _candidates(dirname):
    """Checkpoint names to try, best first: the `latest` pointer target,
    then every other ckpt_<step> newest-first (the fallback chain)."""
    try:
        entries = os.listdir(dirname)
    except OSError:
        return []
    chain = sorted(
        (d for d in entries
         if d.startswith("ckpt_") and _ckpt_step(d) is not None),
        key=_ckpt_step, reverse=True,
    )
    ptr = os.path.join(dirname, "latest")
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                name = f.read().strip()
        except OSError:
            name = ""
        if name in chain:
            chain.remove(name)
            chain.insert(0, name)
    return chain


def newest_valid_checkpoint(dirname, quarantine=True, level="file"):
    """Walk the chain (pointer target first, then newest-first) and
    return the first checkpoint name that verifies; corrupt entries are
    quarantined as `*.corrupt` along the way (quarantine=False only
    inspects). Returns None when nothing valid remains. Defaults to the
    cheap file-level screen (size + whole-file CRC) — callers that will
    LOAD the result (resume()) re-verify fully anyway."""
    for name in _candidates(dirname):
        d = os.path.join(dirname, name)
        try:
            verify_checkpoint(d, level=level)
            return name
        except CheckpointCorruptError as e:
            if quarantine:
                _quarantine(d, str(e))
    return None


def _pinned(dirname, step):
    name = f"ckpt_{int(step)}"
    if not os.path.isdir(os.path.join(dirname, name)):
        raise CheckpointCorruptError(
            f"{dirname}: pinned checkpoint {name} does not exist"
        )
    return name


def load_checkpoint(dirname, scope=None, data_state=None, shardings=None,
                    extra_state=None, step=None, device=None, timings=None):
    """Restore the newest VALID checkpoint into the scope, walking back
    past corrupt/torn entries (quarantining them); returns the step
    AFTER the checkpointed one (0 when nothing valid exists).

    ``step`` pins the restore to exactly ``ckpt_<step>``: a pinned entry
    that is missing or fails verification is quarantined and raises
    ``CheckpointCorruptError`` instead of falling back (an elastic gang's
    sync point must come back identically on every rank).

    `data_state` (anything with load_state_dict()) additionally restores
    the input-iterator position the checkpoint recorded under the
    ``__dataio_state__`` array, from the SAME verified manifest.
    Checkpoints written without data state leave the iterator untouched.

    `extra_state` (anything with owns(name)/restore_arrays(dict) plus
    checkpoint_arrays() on the save side, e.g. an
    embedding.EmbeddingEngine) claims its namespaced arrays — names
    carrying a "::" marker are provider state, never scope variables —
    and restores from them after the scope is populated. With no
    provider attached, provider arrays are skipped, not leaked into the
    scope. Format-2 entries of the scope assemble on the host.

    Scope values become torch tensors of the manifest's dtype on
    ``device`` (default the CPU). `shardings` (the JAX package's restore
    onto a device mesh) is not ported yet (ROADMAP M11). ``timings`` (a
    dict) collects ``verify_checkpoint``'s split and ``upload_s``."""
    if shardings:
        raise NotImplementedError(
            "load_checkpoint(shardings=...): restoring onto a device mesh "
            "is not ported yet (ROADMAP M11)")
    scope = scope or global_scope()
    candidates = [_pinned(dirname, step)] if step is not None \
        else _candidates(dirname)
    for name in candidates:
        d = os.path.join(dirname, name)
        try:
            got_step, arrays = verify_checkpoint(d, assemble=False,
                                                 timings=timings)
            blob = arrays.pop(STATE_KEY, None)
            restored, extra = {}, {}
            for n, a in arrays.items():
                if extra_state is not None and extra_state.owns(n):
                    extra[n] = a.assemble() if isinstance(a, ShardedArray) \
                        else a
                    continue
                if "::" in n:
                    continue  # provider namespace, no provider attached
                restored[n] = a.assemble() if isinstance(a, ShardedArray) \
                    else a
        except CheckpointCorruptError as e:
            _quarantine(d, str(e))
            if step is not None:
                raise CheckpointCorruptError(
                    f"{dirname}: pinned checkpoint {name} failed "
                    f"verification ({e}); quarantined — refusing to "
                    "fall back past an elastic sync point"
                )
            continue
        with _timed(timings, "upload_s"):
            for n, a in restored.items():
                scope.set(n, to_tensor(a, device))
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
        if data_state is not None and blob is not None:
            data_state.load_state_dict(decode_state(blob))
        if extra_state is not None:
            extra_state.restore_arrays(extra)
        return got_step + 1
    return 0


def load_data_state(dirname, step=None):
    """Read ONLY the data-position blob (``__dataio_state__``) from a
    checkpoint, without touching any scope: the decoded state dict, or
    None when the checkpoint carries no data state. ``step`` pins the
    entry exactly like ``load_checkpoint``; without it the newest VALID
    entry is consulted (corrupt entries are quarantined on the walk)."""
    if step is not None:
        name = _pinned(dirname, step)
        d = os.path.join(dirname, name)
        try:
            _, arrays = verify_checkpoint(d, assemble=False)
        except CheckpointCorruptError as e:
            _quarantine(d, str(e))
            raise CheckpointCorruptError(
                f"{dirname}: pinned checkpoint {name} failed "
                f"verification ({e}); quarantined"
            )
        blob = arrays.get(STATE_KEY)
        return decode_state(blob) if blob is not None else None
    for name in _candidates(dirname):
        d = os.path.join(dirname, name)
        try:
            _, arrays = verify_checkpoint(d, assemble=False)
        except CheckpointCorruptError as e:
            _quarantine(d, str(e))
            continue
        blob = arrays.get(STATE_KEY)
        return decode_state(blob) if blob is not None else None
    return None


def gang_generations(dirname):
    """[(step, gang_generation)] for every committed ``ckpt_<step>`` in
    the directory, sorted by step; generation is None for entries
    written outside an elastic supervisor."""
    out = []
    try:
        entries = os.listdir(dirname)
    except OSError:
        return out
    for name in entries:
        if not (name.startswith("ckpt_") and _ckpt_step(name) is not None):
            continue
        man_p = os.path.join(dirname, name, MANIFEST_NAME)
        gen = None
        try:
            with open(man_p) as f:
                gen = json.load(f).get("gang_generation")
        except (OSError, ValueError, json.JSONDecodeError):
            pass
        out.append((_ckpt_step(name), gen))
    return sorted(out)


class AutoCheckpoint:
    """Periodic async checkpoints with auto-resume.

        ckpt = AutoCheckpoint(exe, program, dirname, save_interval_steps=100)
        start_step = ckpt.resume()          # 0 on a fresh run
        for step in range(start_step, n):
            exe.run(...)
            ckpt.maybe_save(step)
        ckpt.close()

    ``save_timings`` holds the last write's split (``snapshot_s`` on the
    training thread; ``serialize_s``, ``crc_s``, ``write_s``,
    ``fsync_s`` on the writer; ``bytes``), ``restore_timings`` the last
    ``resume``'s (``verify_checkpoint``'s split and ``upload_s``).
    """

    def __init__(self, exe, program, dirname, save_interval_steps=100,
                 max_to_keep=3, scope=None, retry=None, data_state=None,
                 extra_state=None, gang_generation=None):
        self._exe = exe
        self._program = program
        self._dir = dirname
        self._interval = int(save_interval_steps)
        self._keep = int(max_to_keep)
        self._scope = scope
        self._data_state = data_state
        self._extra_state = extra_state
        # explicit value wins; else the elastic supervisor's env
        # injection (GANG_GENERATION_ENV); else unstamped (byte-compat)
        self._gang_generation = gang_generation
        self._thread = None
        # guards _last_error/_pending: the async writer thread sets them
        # while save()/close() on the training thread read-and-clear
        self._lock = lockdep.named_lock("checkpoint.manifest")
        self._last_error = None
        self._pending = None  # (step, snap) of an in-flight/failed write
        self._retry = retry if retry is not None else _DEFAULT_IO_RETRY
        self.save_timings = {}
        self.restore_timings = {}
        os.makedirs(dirname, exist_ok=True)

    # -- save ----------------------------------------------------------
    def _persistable_names(self):
        return [
            v.name
            for v in self._program.global_block().vars.values()
            if v.persistable
        ]

    def maybe_save(self, step, blocking=False):
        if (step + 1) % self._interval:
            return False
        self.save(step, blocking=blocking)
        return True

    def _generation(self):
        """gang-generation to stamp, or None: ctor value, else the
        elastic supervisor's env injection (read at write time)."""
        if self._gang_generation is not None:
            return int(self._gang_generation)
        env = os.environ.get(GANG_GENERATION_ENV)
        try:
            return int(env) if env is not None else None
        except ValueError:
            log.warning("ignoring non-integer %s=%r",
                        GANG_GENERATION_ENV, env)
            return None

    def _write(self, step, snap, timings=None):
        """The full crash-consistent write protocol: serialize + manifest
        into a tmp dir, atomic-rename the dir, then atomically swing the
        `latest` pointer. A crash at ANY point leaves either the old
        chain intact or a complete new entry the pointer doesn't name
        yet — both of which resume() handles."""
        d = os.path.join(self._dir, f"ckpt_{step}")
        tmp = d + ".tmp"

        plain = {n: v for n, v in snap.items()
                 if not isinstance(v, _ShardSnap)}
        sharded = {n: v for n, v in snap.items()
                   if isinstance(v, _ShardSnap)}

        pid, world = _process_index(), _process_count()
        if pid != 0:
            # non-chief host: contribute this host's shard file + index
            # sidecar into the shared tmp dir and stop — the chief owns
            # state.npz, the (merged) manifest, meta, and the commit
            def write_host_shards():
                os.makedirs(tmp, exist_ok=True)
                _write_shard_file(tmp, sharded, pid, write_index=True)

            self._retry.call(write_host_shards)
            return

        def write_files():
            if timings is not None:
                for k in ("serialize_s", "crc_s", "write_s", "fsync_s"):
                    timings[k] = 0.0
            if world == 1:
                shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            # serialize in memory first so the whole-file CRC in the
            # manifest is computed from the exact bytes that hit disk
            with _timed(timings, "serialize_s"):
                buf = _io.BytesIO()
                np.savez(buf, **{k: v for k, v in plain.items()})
                raw = buf.getvalue()
            _fsynced_write(os.path.join(tmp, "state.npz"), raw, timings)
            with _timed(timings, "crc_s"):
                files = {
                    "state.npz": {
                        "size": len(raw),
                        "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
                    }
                }
            nbytes = len(raw)
            sharded_manifest = {}
            if sharded:
                # this host's shards, one npz per host
                files_entry, sharded_manifest = _write_shard_file(
                    tmp, sharded, 0, write_index=False, timings=timings
                )
                files.update(files_entry)
                nbytes += sum(f["size"] for f in files_entry.values())
            if world > 1:
                # fold every other host's shard index into THIS manifest
                _merge_host_indices(tmp, world, files, sharded_manifest)
            # injected IO failure lands mid-protocol: state written, no
            # manifest yet — a retry restarts write_files from scratch,
            # a kill leaves classic torn-write debris in the .tmp dir
            faults.fire("checkpoint.io", step=step,
                        path=os.path.join(tmp, "state.npz"))
            gen = self._generation()
            with _timed(timings, "crc_s"):
                arrays = {
                    n: {
                        "crc32": array_crc32(a),
                        "dtype": dtype_name(a),
                        "shape": list(np.shape(a)),
                    }
                    for n, a in plain.items()
                }
            manifest = {
                "format": 2 if sharded_manifest else 1,
                "step": step,
                "arrays": arrays,
                "sharded": sharded_manifest,
                "files": files,
            }
            if not sharded_manifest:
                manifest.pop("sharded")
            if gen is not None:
                manifest["gang_generation"] = gen
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f)
            meta = {"step": step, "time": time.time()}
            if gen is not None:
                meta["gang_generation"] = gen
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if timings is not None:
                timings["bytes"] = nbytes

        self._retry.call(write_files)
        # merged sidecars leave the tree only once every (possibly
        # retried) write_files pass is done — they are not part of the
        # committed checkpoint
        for k in range(1, world):
            try:
                os.remove(os.path.join(tmp, f"shards_p{k}.index.json"))
            except OSError:
                pass
        faults.fire("checkpoint.before_rename", step=step, path=tmp)
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
        # the pointer update is the COMMIT point: resume() prefers the
        # pointer target, so a crash here simply leaves the previous
        # checkpoint committed; the complete new dir only gets used if
        # the pointer target itself is later lost or corrupt
        faults.fire("checkpoint.before_latest", step=step, path=d)
        ptr = os.path.join(self._dir, "latest.tmp")
        with open(ptr, "w") as f:
            f.write(f"ckpt_{step}")
        os.replace(ptr, os.path.join(self._dir, "latest"))
        self._gc()

    def save(self, step, blocking=False):
        """Snapshot the scope NOW (host copies: one pinned copy per card
        tensor and one synchronize), write files on a background thread
        (``blocking=True`` writes before returning)."""
        t0 = time.perf_counter()
        scope = self._scope or global_scope()
        values = {}
        for n in self._persistable_names():
            v = scope.find_var(n)
            if v is not None:
                values[n] = v
        snap = _snapshot(values)
        if self._extra_state is not None:
            # e.g. an EmbeddingEngine: flushes its device hot cache to
            # the authoritative host tier, then hands back the tier as
            # per-shard _ShardSnap entries (the format-2 manifest path)
            snap.update(self._extra_state.checkpoint_arrays())
        if self._data_state is not None:
            # the iterator position is snapshotted at the SAME instant as
            # the parameters, and rides the manifest like any other array
            st = self._data_state.state_dict()
            if st is not None:
                snap[STATE_KEY] = encode_state(st)
        timings = {"snapshot_s": time.perf_counter() - t0}
        # one async writer at a time; a newer save supersedes a pending one
        self._join()
        with self._lock:
            err, self._last_error = self._last_error, None
            if err is not None:
                self._pending = None
        if err is not None:
            raise RuntimeError(
                f"previous async checkpoint write failed: {err}"
            )

        def guarded():
            try:
                self._write(step, snap, timings)
                with self._lock:
                    self._pending = None
                    self.save_timings = timings
            except Exception as e:  # surfaced on the NEXT save, or close()
                log.error("async checkpoint write failed: %s", e)
                with self._lock:
                    self._last_error = e

        with self._lock:
            self._pending = (step, snap)
        if blocking:
            self._write(step, snap, timings)
            with self._lock:
                self._pending = None
                self.save_timings = timings
        else:
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def _gc(self):
        entries = os.listdir(self._dir)
        # clear debris from a save killed mid-write (quarantined
        # *.corrupt entries are kept — they are evidence, not debris)
        for d in entries:
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self._dir, d), ignore_errors=True)
        kept = sorted(
            (d for d in entries
             if d.startswith("ckpt_") and d.split("_", 1)[1].isdigit()),
            key=lambda d: int(d.split("_", 1)[1]),
        )
        for d in kept[: -self._keep]:
            shutil.rmtree(os.path.join(self._dir, d), ignore_errors=True)

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def attach_data_state(self, provider):
        """Register a checkpointable iterator (state_dict/load_state_dict):
        subsequent saves snapshot its position and resume() restores it."""
        self._data_state = provider
        return self

    def attach_extra_state(self, provider):
        """Register a namespaced state provider (checkpoint_arrays /
        owns / restore_arrays — e.g. embedding.EmbeddingEngine): saves
        snapshot its arrays alongside the scope's, resume() hands them
        back."""
        self._extra_state = provider
        return self

    # -- resume ----------------------------------------------------------
    def resume(self, shardings=None, step=None):
        """Restore the newest VALID checkpoint into the scope, on the
        executor's device (verifying CRCs, walking back past corrupt/torn
        entries and quarantining them as *.corrupt); returns the step
        AFTER the checkpointed one (0 on a fresh start). An attached
        data_state gets its iterator position restored from the same
        checkpoint. ``step`` pins the restore to exactly ``ckpt_<step>``
        (no silent walk-back; a bad pinned entry raises
        CheckpointCorruptError instead)."""
        timings = {}
        out = load_checkpoint(
            self._dir, scope=self._scope or global_scope(),
            data_state=self._data_state, shardings=shardings,
            extra_state=self._extra_state, step=step,
            device=None if self._exe is None else self._exe.place.device,
            timings=timings)
        self.restore_timings = timings
        return out

    def close(self):
        """Join the async writer and SURFACE its failure. When the failed
        snapshot is still pending, retry it as a final blocking save
        first — only raise when the state truly could not be persisted."""
        self._join()
        with self._lock:
            err, self._last_error = self._last_error, None
            pending = self._pending
        if err is not None:
            if pending is not None:
                step, snap = pending
                try:
                    self._write(step, snap)
                    with self._lock:
                        self._pending = None
                    log.warning(
                        "final blocking save of step %d recovered the "
                        "failed async write (%s)", step, err,
                    )
                    return
                except Exception as e2:
                    raise RuntimeError(
                        f"async checkpoint write failed: {err}; final "
                        f"blocking save also failed: {e2}"
                    )
            raise RuntimeError(f"async checkpoint write failed: {err}")


class HeartBeatMonitor:
    """Chief-side worker-lost detection over the PS heartbeat table
    (reference: paddle/fluid/operators/distributed/heart_beat_monitor.h:54 —
    UNINITED/RUNNING/COMPLETED per worker, lost workers logged).

        mon = HeartBeatMonitor(client, worker_id=0, worker_num=2,
                               timeout=5.0, on_lost=callback)
        mon.start();  ...  mon.stop()
    """

    def __init__(self, client, worker_id, worker_num, timeout=30.0,
                 period=1.0, on_lost=None):
        self._client = client
        self._id = int(worker_id)
        self._n = int(worker_num)
        self._timeout = float(timeout)
        self._period = float(period)
        self._on_lost = on_lost
        self._stop = threading.Event()
        self._thread = None
        self._seen = set()
        # guards `lost`: the monitor thread adds while callers read
        self._mu = lockdep.named_lock("resilience.heartbeat")
        self.lost = set()

    def _loop(self):
        hb_log = logging.getLogger("paddle_tpu_torch.heartbeat")
        start = time.monotonic()
        while not self._stop.is_set():
            try:
                ages = self._client.heartbeat(self._id)
            except Exception as e:  # server gone: report and stop
                hb_log.warning("heartbeat RPC failed: %s", e)
                break
            self._seen.update(ages)
            # a worker that NEVER heartbeats (died during startup) has no
            # server entry — treat absence past the grace window as lost
            # (the reference's UNINITED state, heart_beat_monitor.h:38)
            elapsed = time.monotonic() - start
            for wid in range(self._n):
                if wid == self._id or wid in ages or wid in self._seen:
                    continue
                if elapsed > self._timeout:
                    ages = dict(ages)
                    ages[wid] = elapsed
            for wid, age in ages.items():
                with self._mu:
                    newly = age > self._timeout and wid not in self.lost
                    if newly:
                        self.lost.add(wid)
                if newly:
                    hb_log.warning(
                        "worker %d LOST: no heartbeat for %.1fs "
                        "(timeout %.1fs)", wid, age, self._timeout,
                    )
                    if self._on_lost is not None:
                        self._on_lost(wid, age)
            self._stop.wait(self._period)

    def start(self):
        # idempotent while the monitor is RUNNING, restartable once it
        # is not: a loop that self-terminated (heartbeat RPC failure)
        # leaves a dead _thread behind, and a stop() whose join timed
        # out keeps the stuck thread pinned here so start() cannot
        # clear _stop underneath it (which would revive it NEXT TO a
        # fresh one)
        if self._thread is not None:
            if self._thread.is_alive():
                return self
            self._thread = None
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if not self._thread.is_alive():
                self._thread = None
