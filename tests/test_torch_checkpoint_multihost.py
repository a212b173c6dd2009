"""The multi-process format-2 save of the port's ``AutoCheckpoint``
(``paddle_tpu_torch/incubate/checkpoint.py``), as
``tests/test_resilience.py``'s four ``test_multihost_*`` /
``test_nonchief_host_writes_shards_and_index_only`` tests drive the JAX
package's: ``_process_index`` / ``_process_count`` are monkeypatched,
host 1's shard file and index are placed in the temporary directory the
way a second process would write them, and the rank-0 save merges
them. Plus the merged directory read across the packages: a two-host
checkpoint the port wrote verifies in the JAX package and the other way
round, with the same stitched array.
"""

import json
import os

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.incubate import checkpoint as jax_ckpt
from paddle_tpu_torch.incubate import checkpoint as ckpt


def _two_host_shard_snaps(mod, dim=4):
    """One [4, dim] array split rows 0-1 (host 0) / 2-3 (host 1)."""
    full = np.arange(4 * dim, dtype=np.float32).reshape(4, dim)
    host0 = mod._ShardSnap((4, dim), "float32", "ep(2)",
                           [((0, 0), (2, dim), full[:2])])
    host1 = mod._ShardSnap((4, dim), "float32", "ep(2)",
                           [((2, 0), (4, dim), full[2:])])
    return full, host0, host1


def _checkpoint(mod, tmp_path, ck_mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        mod.data("x", shape=[-1, 2])
    scope = mod.Scope()
    if mod is pt:
        exe = pt.Executor(place=pt.CPUPlace())
        exe.run(startup, scope=scope)
    else:
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
    return ck_mod.AutoCheckpoint(exe, main, str(tmp_path),
                                 save_interval_steps=1, scope=scope)


def _multihost_save(tmp_path, monkeypatch, mod=pt, ck_mod=ckpt,
                    write_host1_index=True, timeout="1"):
    """A 2-host save: host 1's shard file + index pre-placed in the tmp
    dir (hosts share the checkpoint file system), then the rank-0 save,
    which must merge host 1's index into the manifest."""
    full, host0_snap, host1_snap = _two_host_shard_snaps(ck_mod)
    monkeypatch.setattr(ck_mod, "_process_count", lambda: 2)
    monkeypatch.setenv("PADDLE_TPU_CKPT_MERGE_TIMEOUT", timeout)
    tmp = str(tmp_path / "ckpt_0.tmp")
    os.makedirs(tmp, exist_ok=True)
    if write_host1_index:
        ck_mod._write_shard_file(tmp, {"big": host1_snap}, 1,
                                 write_index=True)
    ck = _checkpoint(mod, tmp_path, ck_mod)
    ck._write(0, {"w0": np.ones(2, "f"), "big": host0_snap})
    return full


def test_multihost_manifest_merge_roundtrip(tmp_path, monkeypatch):
    full = _multihost_save(tmp_path, monkeypatch)
    d = str(tmp_path / "ckpt_0")
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert man["format"] == 2
    assert {"shards_p0.npz", "shards_p1.npz"} <= set(man["files"])
    files = {s["file"] for s in man["sharded"]["big"]["shards"]}
    assert files == {"shards_p0.npz", "shards_p1.npz"}
    # the merged index sidecar is not part of the committed checkpoint
    assert not any(n.endswith(".index.json") for n in os.listdir(d))
    step, arrays = ckpt.verify_checkpoint(d)
    assert step == 0
    np.testing.assert_array_equal(arrays["big"], full)


def test_multihost_missing_host_fails_save_loudly(tmp_path, monkeypatch):
    with pytest.raises(ckpt.CheckpointCorruptError, match="host 1/2"):
        _multihost_save(tmp_path, monkeypatch, write_host1_index=False)
    assert not os.path.exists(tmp_path / "ckpt_0")
    assert not os.path.exists(tmp_path / "latest")


def test_multihost_lost_shard_file_fails_verification(tmp_path, monkeypatch):
    _multihost_save(tmp_path, monkeypatch)
    d = str(tmp_path / "ckpt_0")
    os.remove(os.path.join(d, "shards_p1.npz"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="shards_p1.npz"):
        ckpt.verify_checkpoint(d)


def test_nonchief_host_writes_shards_and_index_only(tmp_path, monkeypatch):
    _full, _h0, host1_snap = _two_host_shard_snaps(ckpt)
    monkeypatch.setattr(ckpt, "_process_index", lambda: 1)
    monkeypatch.setattr(ckpt, "_process_count", lambda: 2)
    ck = _checkpoint(pt, tmp_path, ckpt)
    ck._write(3, {"w0": np.ones(2, "f"), "big": host1_snap})
    tmp = tmp_path / "ckpt_3.tmp"
    assert sorted(os.listdir(tmp)) == ["shards_p1.index.json",
                                       "shards_p1.npz"]
    # no manifest, no meta, no rename, no latest — the chief owns those
    assert not os.path.exists(tmp_path / "ckpt_3")
    assert not os.path.exists(tmp_path / "latest")


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_a_merged_directory_reads_across_the_packages(tmp_path, monkeypatch,
                                                      writer):
    if writer == "torch":
        full = _multihost_save(tmp_path, monkeypatch)
        reader = jax_ckpt
    else:
        full = _multihost_save(tmp_path, monkeypatch, mod=fluid,
                               ck_mod=jax_ckpt)
        reader = ckpt
    d = str(tmp_path / "ckpt_0")
    step, arrays = reader.verify_checkpoint(d)
    assert step == 0
    np.testing.assert_array_equal(np.asarray(arrays["big"]), full)
    np.testing.assert_array_equal(np.asarray(arrays["w0"]), np.ones(2, "f"))
    # a host's blocks, read through the other package's stitched view
    _s, lazy = reader.verify_checkpoint(d, assemble=False)
    np.testing.assert_array_equal(
        np.asarray(lazy["big"].read_slice((2, 0), (4, 4))), full[2:])
