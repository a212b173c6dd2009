"""Checkpoints in the PyTorch port (``incubate/checkpoint.py``) on the CPU:
the JAX package's protocol and files, held against the JAX package.

* ``AutoCheckpoint``: a resumed run replays the uninterrupted run's tail
  bit for bit; ``gc`` keeps ``max_to_keep`` entries and ``latest`` names
  the newest;
* cross-loading: a JAX checkpoint directory verifies and loads in the
  port, and the port's in the JAX package, with the same per-array CRCs
  and bits and manifests equal apart from ``files`` (``np.savez`` stamps
  zip times, so whole files differ);
* format 2: a JAX ``EmbeddingEngine(ep=2)`` host tier restores into the
  port's engine at ep=1 and ep=4 with bit-identical lookups, and the
  reverse;
* walk-back past a corrupt newest entry with quarantine, and a pinned
  ``step=`` that never falls back; ``checkpoint.io`` raised twice and
  retried; a kill at ``checkpoint.before_latest`` in a subprocess leaves
  the previous entry committed;
* the data-state blob's bytes equal between the packages;
* an async save's snapshot untouched by an in-place ``sgd_sparse`` step;
* AMP's dynamic loss-scaling state survives a checkpoint;
* the bfloat16 fault of the reference: the JAX package restores a bf16
  persistable as a 2-byte void array its executor refuses, the port as
  ``torch.bfloat16`` with the same bits.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.embedding import EmbeddingEngine as JaxEngine
from paddle_tpu.incubate import checkpoint as jax_ckpt
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.embedding import EmbeddingEngine
from paddle_tpu_torch.incubate import checkpoint as ckpt
from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.utils import unique_name as torch_names

ROOT = Path(__file__).resolve().parents[1]
B, S, D = 4, 6, 8


def _regression(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod.data("x", shape=[-1, 8], dtype="float32")
        y = mod.data("y", shape=[-1, 1], dtype="float32")
        h = mod.layers.fc(x, size=16, act="relu")
        pred = mod.layers.fc(h, size=1)
        loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
        mod.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(16, 8).astype("float32"),
            "y": rng.randn(16, 1).astype("float32")}


def _port_model(seed=5):
    with torch_names.guard():
        main, startup, loss = _regression(pt)
    startup.random_seed = main.random_seed = seed
    return main, startup, loss


def _cpu():
    return pt.Executor(place=pt.CPUPlace())


def _host(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _same_bits(a, b):
    a, b = _host(a), _host(b)
    return (a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
            and a.tobytes() == b.tobytes())


def test_auto_checkpoint_resume(tmp_path):
    """Crash after step 5, restart from disk into a scope that never ran
    the startup: the replayed tail equals the original run bit for bit."""
    main, startup, loss = _port_model()
    feed = _feed()
    ckdir = str(tmp_path / "ck")
    exe, s1 = _cpu(), pt.Scope()
    exe.run(startup, scope=s1)
    ck = AutoCheckpoint(exe, main, ckdir, save_interval_steps=2,
                        max_to_keep=3, scope=s1)
    assert ck.resume() == 0
    full = []
    for step in range(10):
        full.append(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=s1)[0])
        ck.maybe_save(step, blocking=(step == 5))
    ck.close()

    s2 = pt.Scope()
    ck2 = AutoCheckpoint(exe, main, ckdir, scope=s2)
    with open(os.path.join(ckdir, "latest"), "w") as f:
        f.write("ckpt_5")
    start = ck2.resume()
    assert start == 6
    assert set(ck2.restore_timings) >= {"read_s", "file_crc_s", "parse_s",
                                        "array_crc_s", "upload_s", "bytes"}
    rest = [exe.run(main, feed=feed, fetch_list=[loss], scope=s2)[0]
            for _ in range(start, 10)]
    assert all(_same_bits(a, b) for a, b in zip(rest, full[6:]))


def test_checkpoint_gc_and_latest(tmp_path):
    main, startup, _ = _port_model()
    exe, scope = _cpu(), pt.Scope()
    exe.run(startup, scope=scope)
    ck = AutoCheckpoint(exe, main, str(tmp_path), save_interval_steps=1,
                        max_to_keep=2, scope=scope)
    for step in range(5):
        ck.save(step, blocking=True)
    assert set(ck.save_timings) == {"snapshot_s", "serialize_s", "crc_s",
                                    "write_s", "fsync_s", "bytes"}
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt_"))
    assert kept == ["ckpt_3", "ckpt_4"]
    with open(tmp_path / "latest") as f:
        assert f.read().strip() == "ckpt_4"


def _trained_pair():
    """The regression model in both packages with the same state: the
    JAX startup plus two JAX steps (moments non-zero), carried into the
    port by name."""
    with jax_names.guard():
        jmain, jstartup, jloss = _regression(fluid)
    main, startup, loss = _port_model()
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        for _ in range(2):
            jexe.run(jmain, feed=_feed(), fetch_list=[jloss])
    exe, scope = _cpu(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable]
    load_params(scope, {n: np.asarray(jscope.find_var(n)) for n in names})
    return (jmain, jexe, jscope), (main, exe, scope), names


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man.pop("files")
    return man


def test_checkpoints_cross_load_with_equal_manifests(tmp_path):
    (jmain, jexe, jscope), (main, exe, scope), names = _trained_pair()
    with fluid.scope_guard(jscope):
        jax_ckpt.AutoCheckpoint(jexe, jmain, str(tmp_path / "jax"),
                                scope=jscope).save(3, blocking=True)
    AutoCheckpoint(exe, main, str(tmp_path / "port"),
                   scope=scope).save(3, blocking=True)
    jdir, pdir = tmp_path / "jax" / "ckpt_3", tmp_path / "port" / "ckpt_3"
    assert _manifest(jdir) == _manifest(pdir)
    assert sorted(_manifest(pdir)["arrays"]) == sorted(names)
    # each package verifies the other's directory
    assert ckpt.verify_checkpoint(str(jdir))[0] == 3
    assert jax_ckpt.verify_checkpoint(str(pdir))[0] == 3
    # and loads it: the bits of the saving scope
    into_port, into_jax = pt.Scope(), fluid.Scope()
    assert ckpt.load_checkpoint(str(tmp_path / "jax"), scope=into_port) == 4
    assert jax_ckpt.load_checkpoint(str(tmp_path / "port"),
                                    scope=into_jax) == 4
    for n in names:
        assert _same_bits(into_port.find_var(n), jscope.find_var(n)), n
        assert into_port.find_var(n).device.type == "cpu"
        assert _same_bits(into_jax.find_var(n), scope.find_var(n)), n


def _sharded(mod, capacity, ep):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        ids = mod.data("ids", shape=[-1, S], dtype="int64")
        y = mod.data("y", shape=[-1, S, D], dtype="float32")
        emb = mod.layers.sharded_embedding(
            ids, D, capacity=capacity, ep=ep, name="t0", init_range=0.05,
            lr=0.5, seed=3)
        loss = mod.layers.mean(mod.layers.square(
            mod.layers.elementwise_sub(emb, y)))
        mod.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, emb, loss


class _EngineSide:
    """One package's sharded-embedding program, executor, scope and
    engine."""

    def __init__(self, pkg, capacity, ep):
        self.mod = fluid if pkg == "jax" else pt
        names = jax_names if pkg == "jax" else torch_names
        with names.guard():
            self.main, startup, self.emb, self.loss = _sharded(
                self.mod, capacity, ep)
        self.exe = (fluid.Executor(fluid.CPUPlace()) if pkg == "jax"
                    else _cpu())
        self.scope = self.mod.Scope()
        with self.mod.scope_guard(self.scope):
            self.exe.run(startup)
        self.engine = (JaxEngine if pkg == "jax" else EmbeddingEngine)(
            scope=self.scope)
        self.ckpt = jax_ckpt if pkg == "jax" else ckpt

    def step(self, feed, train=True):
        with self.mod.scope_guard(self.scope):
            feed = self.engine.prepare_feed(self.main, dict(feed),
                                            train=train)
            return _host(self.exe.run(self.main, feed=feed,
                                      fetch_list=[self.emb])[0])

    def checkpoint(self, dirname):
        return self.ckpt.AutoCheckpoint(self.exe, self.main, dirname,
                                        scope=self.scope,
                                        extra_state=self.engine)


def _id_feed(seed):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, 60, (B, S)).astype("int64"),
            "y": rng.randn(B, S, D).astype("float32")}


@pytest.mark.parametrize("ep", [1, 4])
@pytest.mark.parametrize("saver,restorer", [("jax", "port"), ("port", "jax")],
                         ids=["jax_to_port", "port_to_jax"])
def test_format2_engine_restores_n_to_m(tmp_path, saver, restorer, ep):
    src = _EngineSide(saver, capacity=48, ep=2)
    for step in range(3):
        src.step(_id_feed(step))
    src.checkpoint(str(tmp_path)).save(2, blocking=True)
    probe = _id_feed(99)
    want = src.step(probe, train=False)
    src.engine.close()
    man = json.load(open(tmp_path / "ckpt_2" / "manifest.json"))
    assert man["format"] == 2
    rows = man["sharded"]["__embedding_store__::t0::rows"]
    assert len(rows["shards"]) == 2
    assert all({"crc32", "start", "stop", "file"} <= set(sh)
               for sh in rows["shards"])

    dst = _EngineSide(restorer, capacity=96, ep=ep)
    assert dst.checkpoint(str(tmp_path)).resume() == 3
    got = dst.step(probe, train=False)
    assert _same_bits(got, want)
    dst.engine.close()


def _corrupt_chain(tmp_path):
    main, startup, _ = _port_model()
    exe, scope = _cpu(), pt.Scope()
    exe.run(startup, scope=scope)
    ck = AutoCheckpoint(exe, main, str(tmp_path), max_to_keep=3, scope=scope)
    for step in range(3):
        ck.save(step, blocking=True)
    faults.corrupt_file(str(tmp_path / "ckpt_2" / "state.npz"))
    return exe, main


def test_walk_back_quarantines_the_corrupt_newest(tmp_path):
    exe, main = _corrupt_chain(tmp_path)
    assert AutoCheckpoint(exe, main, str(tmp_path),
                          scope=pt.Scope()).resume() == 2
    assert (tmp_path / "ckpt_2.corrupt").is_dir()
    assert not (tmp_path / "ckpt_2").exists()
    # both packages' walks agree on the remaining chain
    assert ckpt.newest_valid_checkpoint(str(tmp_path)) == "ckpt_1"
    assert jax_ckpt.newest_valid_checkpoint(str(tmp_path)) == "ckpt_1"
    assert ckpt.gang_generations(str(tmp_path)) == \
        jax_ckpt.gang_generations(str(tmp_path)) == [(0, None), (1, None)]


def test_a_pinned_step_never_falls_back(tmp_path):
    exe, main = _corrupt_chain(tmp_path)
    ck = AutoCheckpoint(exe, main, str(tmp_path), scope=pt.Scope())
    with pytest.raises(ckpt.CheckpointCorruptError, match="pinned"):
        ck.resume(step=2)
    assert (tmp_path / "ckpt_2.corrupt").is_dir()
    with pytest.raises(ckpt.CheckpointCorruptError, match="does not exist"):
        ck.resume(step=7)
    assert ck.resume(step=0) == 1
    with pytest.raises(NotImplementedError, match="M11"):
        ck.resume(shardings={"x": object()})


def test_checkpoint_io_fault_is_retried(tmp_path):
    main, startup, _ = _port_model()
    exe, scope = _cpu(), pt.Scope()
    exe.run(startup, scope=scope)
    try:
        faults.configure([{"site": "checkpoint.io", "action": "raise",
                           "times": 2}])
        AutoCheckpoint(exe, main, str(tmp_path), scope=scope).save(
            0, blocking=True)
        fired = sum(r["fired"] for r in
                    faults.get_injector().rule_stats().values())
    finally:
        faults.reset()
    assert fired == 2
    assert ckpt.verify_checkpoint(str(tmp_path / "ckpt_0"))[0] == 0
    with open(tmp_path / "latest") as f:
        assert f.read() == "ckpt_0"


_KILL_SCRIPT = """
import sys
import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint
from paddle_tpu_torch.resilience import faults
main, startup = pt.Program(), pt.Program()
with pt.program_guard(main, startup):
    x = pt.data("x", shape=[-1, 4], dtype="float32")
    pt.layers.fc(x, size=2)
exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
exe.run(startup, scope=scope)
ck = AutoCheckpoint(exe, main, sys.argv[1], scope=scope)
ck.save(0, blocking=True)
faults.configure([{"site": "checkpoint.before_latest", "action": "kill",
                   "exit_code": 17}])
ck.save(1, blocking=True)
print("not killed")
"""


def test_a_kill_before_latest_leaves_the_previous_entry_committed(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("PADDLE_TPU_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", _KILL_SCRIPT, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "not killed" not in proc.stdout, (
        proc.stdout + proc.stderr)
    with open(tmp_path / "latest") as f:
        assert f.read() == "ckpt_0"
    # the new entry was renamed into place, complete, but never committed
    assert ckpt.verify_checkpoint(str(tmp_path / "ckpt_1"))[0] == 1
    scope = pt.Scope()
    assert ckpt.load_checkpoint(str(tmp_path), scope=scope) == 1


class _Position:
    def __init__(self, state=None):
        self.state = state

    def state_dict(self):
        return self.state

    def load_state_dict(self, d):
        self.state = d


POSITION = {"version": 2, "epoch": 3, "cursor": 17, "base": 0,
            "emitted_batches": 41, "seed": 9, "world": 1, "rank": 0,
            "rng": None}


def test_the_data_state_blob_is_the_jax_packages(tmp_path):
    from paddle_tpu.dataio import state as jax_state
    from paddle_tpu_torch.dataio import state

    assert state.encode_state(POSITION).tobytes() == \
        jax_state.encode_state(POSITION).tobytes()
    (jmain, jexe, jscope), (main, exe, scope), _ = _trained_pair()
    with fluid.scope_guard(jscope):
        jax_ckpt.AutoCheckpoint(jexe, jmain, str(tmp_path / "jax"),
                                scope=jscope, data_state=_Position(POSITION)
                                ).save(0, blocking=True)
    AutoCheckpoint(exe, main, str(tmp_path / "port"), scope=scope,
                   data_state=_Position(POSITION)).save(0, blocking=True)
    blobs = []
    for pkg in ("jax", "port"):
        with np.load(tmp_path / pkg / "ckpt_0" / "state.npz") as z:
            blobs.append(z[state.STATE_KEY].tobytes())
    assert blobs[0] == blobs[1]
    assert _manifest(tmp_path / "jax" / "ckpt_0") == \
        _manifest(tmp_path / "port" / "ckpt_0")
    assert ckpt.load_data_state(str(tmp_path / "jax")) == POSITION
    assert jax_ckpt.load_data_state(str(tmp_path / "port")) == POSITION
    got = _Position()
    AutoCheckpoint(exe, main, str(tmp_path / "jax"), scope=pt.Scope(),
                   data_state=got).resume()
    assert got.state == POSITION


def test_an_async_snapshot_is_isolated_from_in_place_updates(tmp_path):
    from paddle_tpu_torch.models import ctr

    with torch_names.guard():
        main, startup, _feeds, (loss, _pred) = ctr.build_ctr_train(
            num_slots=2, ids_per_slot=3, hidden=(8,), ps_mode=False,
            vocab_size=64, optimizer=pt.optimizer.SGD(0.1))
    exe, scope = _cpu(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)

    def feed():
        f = ctr.synthetic_batch(rng, 8, num_slots=2, id_space=64)
        return f

    exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    assert any(op.type == "sgd_sparse" for op in main.global_block().ops)
    table = scope.find_var("deep_0_w")
    saved = persistables_to_numpy(scope, main)
    try:
        # hold the writer inside its protocol while training goes on
        faults.configure([{"site": "checkpoint.io", "action": "stall",
                           "delay_s": 0.5}])
        ck = AutoCheckpoint(exe, main, str(tmp_path), scope=scope)
        ck.save(0)
        exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
        assert ck._thread is not None and ck._thread.is_alive()
        ck.close()
    finally:
        faults.reset()
    # the step updated the table's own tensor in place
    assert scope.find_var("deep_0_w") is table
    assert not np.array_equal(table.numpy(), saved["deep_0_w"])
    back = pt.Scope()
    assert ckpt.load_checkpoint(str(tmp_path), scope=back) == 1
    for n, a in saved.items():
        assert _same_bits(back.find_var(n), a), n


def test_dynamic_loss_scaling_state_survives_a_checkpoint(tmp_path):
    with torch_names.guard():
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.data("x", shape=[-1, 8], dtype="float32")
            y = pt.data("y", shape=[-1, 1], dtype="float32")
            pred = pt.layers.fc(pt.layers.fc(x, size=16, act="relu"), size=1)
            loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
            opt = pt.amp.decorate(
                pt.optimizer.SGD(0.01), dest_dtype="float16",
                init_loss_scaling=2.0 ** 15, use_dynamic_loss_scaling=True,
                incr_every_n_steps=2)
            opt.minimize(loss)
    startup.random_seed = main.random_seed = 3
    state = [v.name for v in main.global_block().vars.values()
             if v.persistable and "loss_scaling" in v.name
             or "num_good_steps" in v.name or "num_bad_steps" in v.name]
    assert len(state) >= 3, state
    exe, scope = _cpu(), pt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    ck = AutoCheckpoint(exe, main, str(tmp_path), scope=scope)
    ck.save(2, blocking=True)
    saved = {n: _host(scope.find_var(n)).copy() for n in state}

    def tail(s):
        out = [exe.run(main, feed=_feed(1), fetch_list=[loss], scope=s)[0]
               for _ in range(3)]
        return out, {n: _host(s.find_var(n)) for n in state}

    want_losses, want_state = tail(scope)
    back = pt.Scope()
    assert AutoCheckpoint(exe, main, str(tmp_path), scope=back).resume() == 3
    for n in state:
        assert _same_bits(back.find_var(n), saved[n]), n
    got_losses, got_state = tail(back)
    assert all(_same_bits(a, b) for a, b in zip(got_losses, want_losses))
    for n in state:
        assert _same_bits(got_state[n], want_state[n]), n
    # the scaling state moved in the tail, so the restored counters
    # decided it
    assert not all(_same_bits(want_state[n], saved[n]) for n in state), (
        saved, want_state)


def _bf16_program(mod):
    main = mod.Program()
    main.global_block().create_var(name="w_bf16", shape=[3, 5],
                                   dtype="bfloat16", persistable=True)
    main.global_block().create_var(name="b", shape=[5], dtype="float32",
                                   persistable=True)
    return main


BF16_BITS = np.random.RandomState(4).randint(
    0, 2**16, size=(3, 5)).astype(np.uint16)
F32 = np.arange(5, dtype=np.float32)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_bf16_persistables_the_reference_cannot_restore(tmp_path, saver):
    import jax.numpy as jnp

    if saver == "jax":
        scope = fluid.Scope()
        scope.set("w_bf16", jnp.asarray(BF16_BITS.view(ml_dtypes.bfloat16)))
        scope.set("b", jnp.asarray(F32))
        jax_ckpt.AutoCheckpoint(fluid.Executor(fluid.CPUPlace()),
                                _bf16_program(fluid), str(tmp_path),
                                scope=scope).save(0, blocking=True)
    else:
        scope = pt.Scope()
        scope.set("w_bf16", torch.from_numpy(BF16_BITS.view(np.int16)).view(
            torch.bfloat16))
        scope.set("b", torch.from_numpy(F32.copy()))
        AutoCheckpoint(_cpu(), _bf16_program(pt), str(tmp_path),
                       scope=scope).save(0, blocking=True)
    man = json.load(open(tmp_path / "ckpt_0" / "manifest.json"))
    assert man["arrays"]["w_bf16"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "ckpt_0" / "state.npz") as z:
        assert z["w_bf16"].dtype.kind == "V"
    # the reference's fault: a 2-byte void array in its scope, which JAX
    # refuses as an array type
    jscope = fluid.Scope()
    jax_ckpt.load_checkpoint(str(tmp_path), scope=jscope)
    restored = jscope.find_var("w_bf16")
    assert np.asarray(restored).dtype.kind == "V"
    with pytest.raises(TypeError):
        jnp.asarray(restored)
    # the port reads it by the manifest's dtype
    pscope = pt.Scope()
    assert ckpt.load_checkpoint(str(tmp_path), scope=pscope) == 1
    got = pscope.find_var("w_bf16")
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == BF16_BITS.tobytes()
    assert _same_bits(pscope.find_var("b"), F32)
