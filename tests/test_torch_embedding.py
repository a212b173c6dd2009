"""The embedding engine of the PyTorch port against the JAX package, at a
small size on the CPU:

* the numpy halves (``splitmix64``, ``hash_shard``, ``init_rows``,
  ``dedup_ids``, ``pad_slot``, ``pad_slots``, ``click_log``) give the same
  bytes as the JAX package's;
* the admission kernel's plain version (K5, ``scatter_rows`` on a CPU
  slab) equals the JAX package's composite and its Pallas kernel in
  interpret mode bit for bit, pad slots, D = 1 and D = 16, and the rows no
  slot names included; ``read_rows`` equals the JAX gather; K5's staging
  layout packs ``pad_slots``' real entries and nothing else (a pure
  function), and ``admit_rows`` over the real rows gives the bytes of the
  padded bucket;
* the port's cache-size invariance on Wide&Deep (``models/wide_deep.py``,
  batch 32, 10 click-log steps): capacity 64, which evicts every step,
  and 4096 give the same losses and host tiers bit for bit (the engine
  against the JAX package's is ``test_torch_wide_deep.py``);
* the engine's overflow error, the rewrite that strips Adam off the slabs
  (and its build error), write-back and staleness, eviction write-back,
  and prefetch.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.dataio import sparse as jax_sparse
from paddle_tpu.embedding import gather as jax_gather
from paddle_tpu.embedding import table as jax_table
from paddle_tpu.kernels import embedding as jax_kemb
from paddle_tpu_torch import kernels
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.dataio import sparse as torch_sparse
from paddle_tpu_torch.embedding import EmbeddingEngine
from paddle_tpu_torch.embedding import gather as torch_gather
from paddle_tpu_torch.embedding import table as torch_table
from paddle_tpu_torch.kernels import embedding as kemb
from paddle_tpu_torch.models import wide_deep as torch_wd
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.enforce import EnforceError

ROOT = Path(__file__).resolve().parents[1]
BATCH, CAPACITY, STEPS = 32, 64, 10


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "wide_deep_example", ROOT / "examples" / "wide_deep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# numpy halves: the same bytes
# ---------------------------------------------------------------------------


def _ids(seed, n=64):
    rng = np.random.RandomState(seed)
    return np.concatenate([
        rng.randint(0, 2**62, n, dtype=np.int64).astype(np.uint64),
        np.array([0, 1, 2**40 + 7, 2**64 - 1], dtype=np.uint64)])


@pytest.mark.parametrize("seed", [0, 9, 2**31 - 1])
def test_hash_and_init_bytes_match_jax(seed):
    ids = _ids(seed)
    assert np.array_equal(torch_table.splitmix64(ids),
                          jax_table.splitmix64(ids))
    for n in (1, 2, 3, 8):
        got = torch_table.hash_shard(ids, n, seed)
        assert got.dtype == np.int64
        assert np.array_equal(got, jax_table.hash_shard(ids, n, seed))
    for dim, rng_ in ((16, 0.01), (1, 0.0), (5, 0.25)):
        got = torch_table.init_rows(ids, dim, rng_, seed)
        want = jax_table.init_rows(ids, dim, rng_, seed)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()


def test_table_config_matches_jax():
    entry = dict(table_name="deep_0", dim=16, capacity=4096, ep=2,
                 init_range=0.01, lr=0.1, seed=200, min_bucket=8)
    got = torch_table.TableConfig.from_entry(entry)
    want = jax_table.TableConfig.from_entry(entry)
    assert got.to_attrs() == want.to_attrs()
    assert got.cap_per_shard == want.cap_per_shard == 2048
    with pytest.raises(EnforceError, match="multiple of ep"):
        torch_table.TableConfig("t", 4, capacity=10, ep=4)


@pytest.mark.parametrize("min_bucket", [1, 8, 64])
@pytest.mark.parametrize("dedup", [True, False])
def test_dedup_ids_match_jax(min_bucket, dedup):
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 40, (32, 5)).astype(np.int64)
    got, want = (torch_gather.dedup_ids(ids, min_bucket, dedup),
                 jax_gather.dedup_ids(ids, min_bucket, dedup))
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[2].dtype == want[2].dtype == np.int32
    assert np.array_equal(got[2], want[2])
    for n in (0, 1, 7, 8, 9, 1000):
        assert torch_gather.next_bucket(n, min_bucket) == \
            jax_gather.next_bucket(n, min_bucket)


@pytest.mark.parametrize("ids", [[], [7], [3, 3, 9], [1, 2, 3, 4, 5, 6, 7]])
def test_pad_slot_and_transform_match_jax(ids):
    for got, want in zip(torch_sparse.pad_slot(ids, 5),
                         jax_sparse.pad_slot(ids, 5)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    rec = {"slots": {"a": ids, "b": [11]}, "click": 1.0}
    got = torch_sparse.make_sparse_batch_transform(["a", "b", "c"], 5)(rec)
    want = jax_sparse.make_sparse_batch_transform(["a", "b", "c"], 5)(rec)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_click_log_matches_the_jax_example():
    want = list(_jax_example().click_log(200, seed=0))
    assert list(torch_wd.click_log(200, seed=0)) == want


# ---------------------------------------------------------------------------
# K5: the admission scatter
# ---------------------------------------------------------------------------


def _admission(seed, cap, dim, n):
    rng = np.random.RandomState(seed)
    slab = rng.randn(cap, dim).astype(np.float32)
    slots = rng.choice(cap, n, replace=False)
    rows = rng.randn(n, dim).astype(np.float32)
    return slab, slots, rows


@pytest.mark.parametrize("cap,dim,n", [(64, 16, 37), (64, 1, 33),
                                       (4096, 16, 256), (16, 3, 1),
                                       (32, 16, 32)])
def test_admission_plain_matches_jax_composite_and_interpret(cap, dim, n):
    slab, slots, rows = _admission(cap + dim + n, cap, dim, n)
    s, r = kemb.pad_slots(slots, rows, cap, dim, np.float32)
    js, jr = jax_kemb.pad_slots(slots, rows, cap, dim, np.float32)
    assert np.array_equal(s, js) and np.array_equal(r, jr)
    assert len(s) == kemb.admit_bucket(n) == jax_kemb.admit_bucket(n)
    assert (s == cap).sum() == len(s) - n      # pad slots write nowhere

    composite = np.asarray(jax_kemb._scatter_composite(
        jnp.asarray(slab), jnp.asarray(s), jnp.asarray(r)))
    interpret = np.asarray(jax_kemb._scatter_pallas(
        jnp.asarray(slab), jnp.asarray(s), jnp.asarray(r), interpret=True))
    assert composite.tobytes() == interpret.tobytes()

    for fn in (kemb.scatter_rows_plain, kemb.scatter_rows):
        got = torch.from_numpy(slab.copy())
        ptr = got.data_ptr()
        assert fn(got, s, r) is got and got.data_ptr() == ptr   # in place
        assert got.numpy().tobytes() == composite.tobytes()
    untouched = np.setdiff1d(np.arange(cap), slots)
    assert np.array_equal(got.numpy()[untouched], slab[untouched])

    got = torch.from_numpy(slab.copy())
    kemb.admit_rows(got, slots, rows)
    assert got.numpy().tobytes() == composite.tobytes()
    with kernels.scoped_mode("off"):
        got = torch.from_numpy(slab.copy())
        kemb.admit_rows(got, slots, rows)
        assert got.numpy().tobytes() == composite.tobytes()


def test_admission_rejects_a_slot_outside_the_slab():
    slab, slots, rows = _admission(1, 16, 4, 3)
    t = torch.from_numpy(slab.copy())
    for bad in (16 + 1, -1):
        with pytest.raises(ValueError, match="outside"):
            kemb.scatter_rows(t, np.array([0, bad, 2]), rows)
    with pytest.raises(ValueError, match="shape"):
        kemb.scatter_rows(t, np.array([0, 1]), rows)
    assert np.array_equal(t.numpy(), slab)


PACK_CASES = [(64, 16, 37), (64, 1, 33), (4096, 16, 256), (16, 3, 1),
              (32, 16, 32)]


@pytest.mark.parametrize("cap,dim,n", PACK_CASES)
def test_admission_packing_is_pad_slots_truncated(cap, dim, n):
    """K5's staging buffer holds the real rows only: read back at
    ``admission_layout``'s offsets, its slots and rows are ``pad_slots``'
    first ``n``. Packing is a pure function: the same bytes into a given
    buffer as into a new one, nothing written past the layout, its inputs
    untouched."""
    _, slots, rows = _admission(cap + dim + n + 1, cap, dim, n)
    s, r = kemb.pad_slots(slots, rows, cap, dim, np.float32)
    off, size = kemb.admission_layout(n, dim)
    assert off % 16 == 0 and 4 * n <= off < 4 * n + 16
    assert size == off + 4 * n * dim
    slots_in, rows_in = slots.copy(), rows.copy()
    new = kemb.pack_admission(slots, rows)
    out = np.full(size + 64, 0xAB, np.uint8)
    into = kemb.pack_admission(slots, rows, out=out)
    assert len(new) == len(into) == size and np.shares_memory(into, out)
    assert (out[size:] == 0xAB).all()
    for buf in (new, into):
        assert np.array_equal(buf[:4 * n].view(np.int32), s[:n])
        assert buf[off:].view(np.float32).reshape(n, dim).tobytes() == \
            r[:n].tobytes()
    assert np.array_equal(slots, slots_in) and np.array_equal(rows, rows_in)


@pytest.mark.parametrize("cap,dim,n", PACK_CASES)
def test_admit_rows_over_the_real_rows_equals_the_padded_bucket(cap, dim, n):
    """``admit_rows`` uploads the real rows only; in either kernel mode the
    slab gets the bytes that the padded bucket gives, which are the JAX
    composite's. An empty admission writes nothing."""
    slab, slots, rows = _admission(cap + dim + n + 2, cap, dim, n)
    s, r = kemb.pad_slots(slots, rows, cap, dim, np.float32)
    padded = kemb.scatter_rows(torch.from_numpy(slab.copy()), s, r)
    composite = np.asarray(jax_kemb._scatter_composite(
        jnp.asarray(slab), jnp.asarray(s), jnp.asarray(r)))
    assert padded.numpy().tobytes() == composite.tobytes()
    for mode in ("auto", "off"):
        with kernels.scoped_mode(mode):
            got = torch.from_numpy(slab.copy())
            assert kemb.admit_rows(got, slots, rows, kemb.Staging()) is got
            assert got.numpy().tobytes() == composite.tobytes()
            kemb.admit_rows(got, [], np.zeros((0, dim), np.float32))
            assert got.numpy().tobytes() == composite.tobytes()


def test_read_rows_matches_jax():
    slab, slots, _ = _admission(2, 64, 16, 11)
    got = kemb.read_rows(torch.from_numpy(slab), slots)
    want = jax_kemb.read_rows(jnp.asarray(slab), slots)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# Wide&Deep on the port alone
# ---------------------------------------------------------------------------


def _torch_wide_deep(batches, capacity, min_bucket=8, state=None):
    with torch_names.guard():
        main, startup, feeds, (loss, _pred) = torch_wd.build_programs(
            capacity=capacity, min_bucket=min_bucket)
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    if state is not None:
        load_params(scope, state)
    engine = EmbeddingEngine(scope=scope)
    losses = []
    for batch in batches:
        feed = engine.prepare_feed(main, dict(batch))
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0].reshape(-1)[0]))
    host = engine.host_rows()
    stats = engine.stats()
    engine.close()
    return dict(losses=losses, stats=stats, host=host, main=main,
                final=persistables_to_numpy(scope, main))


@pytest.fixture(scope="module")
def batches():
    records = list(torch_wd.click_log(BATCH * STEPS, seed=0))
    with torch_names.guard():
        feeds = torch_wd.build_programs()[2]
    return [torch_wd.make_batch(records[i * BATCH:(i + 1) * BATCH], feeds)
            for i in range(STEPS)]


def test_training_is_bit_identical_across_cache_capacities(batches):
    """The engine's contract on the port: a cache that evicts every step
    and one that holds everything train the same bits. Default bucket
    sizes, so the slot feeds change length from step to step."""
    small = _torch_wide_deep(batches, capacity=CAPACITY, min_bucket=8)
    big = _torch_wide_deep(batches, capacity=4096, min_bucket=8)
    assert all(st["evictions"] > 0 for st in small["stats"].values())
    assert all(st["evictions"] == 0 for st in big["stats"].values())
    assert small["losses"] == big["losses"]
    for t, rows in big["host"].items():
        assert set(small["host"][t]) == set(rows), t
        for i, row in rows.items():
            assert small["host"][t][i].tobytes() == row.tobytes(), (t, i)


# ---------------------------------------------------------------------------
# engine behaviour on a one-table program
# ---------------------------------------------------------------------------

B, S, D = 4, 3, 8


def _build_sharded(capacity, ep, opt="sgd"):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = pt.data("ids", shape=[-1, S], dtype="int64")
        y = pt.data("y", shape=[-1, S, D], dtype="float32")
        emb = pt.layers.sharded_embedding(
            ids, D, capacity=capacity, ep=ep, name="t0", init_range=0.05,
            lr=0.5, seed=3)
        loss = pt.layers.mean(pt.layers.elementwise_mul(emb, y))
        optimizer = (pt.optimizer.Adam(learning_rate=1e-3) if opt == "adam"
                     else pt.optimizer.SGD(learning_rate=0.5))
        optimizer.minimize(loss)
    return main, startup, loss


def _started(capacity, ep, opt="sgd"):
    main, startup, loss = _build_sharded(capacity, ep, opt)
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    return main, exe, scope, loss, EmbeddingEngine(scope=scope)


def _feed(seed, vocab=8):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, vocab, (B, S)).astype("int64"),
            "y": rng.randn(B, S, D).astype("float32")}


def test_capacity_overflow_is_clear_error():
    main, exe, scope, loss, eng = _started(8, 2)  # 4 slots/shard < uniques
    idv = np.arange(B * S, dtype=np.int64).reshape(B, S)
    with pytest.raises(EnforceError, match="cache slots for ONE batch"):
        eng.prepare_feed(main, {"ids": idv})
    eng.close()


def test_rewrite_strips_dense_optimizer_and_slots():
    main, exe, scope, loss, eng = _started(16, 2, opt="adam")
    feed = eng.prepare_feed(main, {"ids": np.zeros((B, S), "int64"),
                                   "y": np.zeros((B, S, D), "float32")})
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    eng.close()
    types = [op.type for op in main.global_block().ops]
    assert "sharded_embedding_sgd" in types
    assert "sharded_embedding_lookup_grad" not in types
    assert "adam" not in types                  # the slab was the only param
    assert not any("t0__slab_moment" in n for n in main.global_block().vars)


def test_a_slab_grad_the_pass_cannot_fuse_is_a_build_error():
    main, exe, scope, loss, eng = _started(16, 2)
    block = main.global_block()
    block.create_var(name="probe", shape=None, dtype="float32")
    block.append_op("scale", {"X": ["t0__slab@GRAD"]}, {"Out": ["probe"]},
                    {"scale": 2.0})
    feed = eng.prepare_feed(main, _feed(0))
    with pytest.raises(EnforceError, match="sharded table slab"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    eng.close()


def test_writeback_updates_store_and_staleness():
    main, exe, scope, loss, eng = _started(16, 2)
    feed = eng.prepare_feed(main, _feed(1))
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    rt = eng.tables["t0"]
    assert rt._dirty, "trained rows must be marked dirty"
    assert rt.staleness() >= 0.0 and rt._oldest_dirty is not None
    before = kemb.roundtrips()
    eng.flush()
    assert kemb.roundtrips() == before          # flush reads dirty rows only
    assert not rt._dirty and rt.staleness() == 0.0
    slab = rt.slab().cpu().numpy()
    for i, slot in rt._slot.items():
        np.testing.assert_array_equal(rt.store.pull([i])[0][0], slab[slot])
    # the trained rows moved off their initial values
    assert any(not np.array_equal(slab[s], rt.cfg.init_for([i])[0])
               for i, s in rt._slot.items())
    assert rt.stats()["occupancy"] == len(rt._slot)
    eng.close()


def test_eviction_writes_back_before_the_slot_is_reused():
    """With 2 slots in all, each new batch evicts the last one's rows:
    their trained values must reach the host tier, and a re-admitted id
    must come back with its trained value."""
    main, exe, scope, loss, eng = _started(2, 1)
    rt = None
    trained = {}
    for step in range(4):
        idv = (np.arange(B * S).reshape(B, S) % 2 + 2 * (step % 2)).astype(
            "int64")
        feed = eng.prepare_feed(main, {"ids": idv, "y": _feed(step)["y"]})
        rt = eng.tables["t0"]
        if step == 2:   # ids 0 and 1 were evicted at step 1, now re-admitted
            slab = rt.slab().numpy()
            for i in (0, 1):
                np.testing.assert_array_equal(slab[rt._slot[i]], trained[i])
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        if step == 0:
            slab = rt.slab().numpy()
            trained = {i: slab[rt._slot[i]].copy() for i in (0, 1)}
    assert rt.stats()["evictions"] > 0 and rt.stats()["writebacks"] > 0
    eng.close()


def test_prefetch_materializes_ahead():
    main, exe, scope, loss, eng = _started(32, 2)
    nxt = {"ids": np.arange(B * S, dtype=np.int64).reshape(B, S)}
    for f in eng.prefetch(main, nxt):
        f.result()
    rt = eng.tables["t0"]
    assert rt.prefetched == B * S
    assert len(rt.store) == B * S
    # the lookup then finds every row resident: nothing new materializes
    eng.prepare_feed(main, dict(nxt))
    assert len(rt.store) == B * S and rt.stats()["misses"] == B * S
    eng.close()

