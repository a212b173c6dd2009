"""The embedding admission kernel (K5) and the sparse row update kernel
(K6) against their plain versions on the card, at ragged sizes (M = 1, 3,
257 rows; D = 1, 3, 16, 129), with the drop slot, id 0 among the ids with
fill rows past the unique count, int32 and int64 ids, a slot outside the
slab raising before the upload, and the in-place update of a scope's
tensor; K5's staging buffer reused and grown, and two admissions through
one staging while the card is busy; an id outside the table raising
``ValueError`` on K6's next call and by the end of ``Executor.run`` (as
the ``EnforceError`` of ``sgd_sparse``), with no row outside the update
changed; the host syncs of one ``sgd_sparse`` (one: ``torch.unique``'s)
and of ``admit_rows`` (none); then a small Wide&Deep run on the card,
bit-identical across cache capacities. Marked ``cuda``: it skips without a card and runs on one
with

    python -m pytest -m cuda tests/test_torch_embedding_cuda.py -q

Both kernels only move or add each element once, so the bar is bit
equality with the plain versions.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels
from paddle_tpu_torch.embedding import EmbeddingEngine
from paddle_tpu_torch.kernels import embedding as kemb
from paddle_tpu_torch.kernels import sparse_update as su
from paddle_tpu_torch.core.backward import resolve_op_def
from paddle_tpu_torch.models import wide_deep as wd
from paddle_tpu_torch.models.ctr import sgd_sparse_program
from paddle_tpu_torch.utils import unique_name
from paddle_tpu_torch.utils.enforce import EnforceError
from paddle_tpu_torch.utils.flags import flags

pytestmark = pytest.mark.cuda

ROWS = (1, 3, 257)
DIMS = (1, 3, 16, 129)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _syncs(fn):
    """Host syncs of ``fn()`` under PyTorch's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # not the mode's one-time notice that it is a prototype feature
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("d", DIMS)
def test_admission_kernel_matches_plain(dev, m, d):
    rng = np.random.RandomState(m * 1000 + d)
    cap = m + 40
    slab = torch.from_numpy(rng.randn(cap, d).astype(np.float32)).to(dev)
    slots, rows = kemb.pad_slots(rng.choice(cap, m, replace=False),
                                 rng.randn(m, d).astype(np.float32), cap, d,
                                 np.float32)
    if len(slots) == m:          # no bucket padding at this m: add a drop slot
        slots = np.append(slots, cap).astype(np.int32)
        rows = np.concatenate([rows, rng.randn(1, d).astype(np.float32)])
    got, want = slab.clone(), slab.clone()
    before = kernels.launches("embedding_admission")
    assert kemb.scatter_rows(got, slots, rows) is got
    kemb.scatter_rows_plain(want, slots, rows)
    torch.cuda.synchronize()
    assert kernels.launches("embedding_admission") == before + 1
    assert torch.equal(got, want)
    untouched = torch.from_numpy(np.setdiff1d(np.arange(cap), slots)).to(dev)
    assert torch.equal(got[untouched], slab[untouched])


def test_admission_rejects_a_slot_outside_the_slab(dev):
    slab = torch.zeros(8, 4, device=dev)
    rows = np.ones((2, 4), np.float32)
    before = kernels.launches("embedding_admission")
    for bad in (9, -1):
        with pytest.raises(ValueError, match="outside"):
            kemb.scatter_rows(slab, np.array([0, bad]), rows)
    with pytest.raises(ValueError, match="host"):
        kemb.scatter_rows(slab, torch.tensor([0, 1], device=dev), rows)
    assert kernels.launches("embedding_admission") == before
    assert not slab.any()


def test_admission_updates_the_scope_tensor_in_place(dev):
    scope = pt.Scope()
    slab = torch.zeros(16, 16, device=dev)
    scope.set("t__slab", slab)
    rows = np.arange(3 * 16, dtype=np.float32).reshape(3, 16)
    kemb.admit_rows(scope.find_var("t__slab"), [4, 0, 15], rows)
    assert scope.find_var("t__slab") is slab
    np.testing.assert_array_equal(slab[[4, 0, 15]].cpu().numpy(), rows)
    np.testing.assert_array_equal(kemb.read_rows(slab, [15, 4]), rows[[2, 0]])


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("d", DIMS)
def test_row_update_kernel_matches_plain(dev, m, d):
    """Id 0 among the real ids, and as many fill rows past ``n_unique``,
    holding NaN: a kernel that touched one would poison row 0."""
    rng = np.random.RandomState(m * 1000 + d)
    vocab = 4 * m + 10
    param = torch.from_numpy(rng.randn(vocab, d).astype(np.float32)).to(dev)
    ids = np.concatenate([[0], rng.choice(np.arange(1, vocab), m - 1,
                                          replace=False)]).astype(np.int32)
    rng.shuffle(ids)
    rows = rng.randn(m, d).astype(np.float32)
    ids_t = torch.from_numpy(np.concatenate(
        [ids, np.zeros(m, np.int32)])).to(dev)
    rows_t = torch.from_numpy(np.concatenate(
        [rows, np.full((m, d), np.nan, np.float32)])).to(dev)
    got, want = param.clone(), param.clone()
    before = kernels.launches("sparse_row_update")
    assert su.sparse_row_update(got, ids_t, rows_t, n_unique=m) is got
    su.sparse_row_update_plain(want, ids_t, rows_t, n_unique=m)
    torch.cuda.synchronize()
    assert kernels.launches("sparse_row_update") == before + 1
    assert torch.equal(got, want)
    assert torch.isfinite(got).all()
    untouched = torch.from_numpy(np.setdiff1d(np.arange(vocab), ids)).to(dev)
    assert torch.equal(got[untouched], param[untouched])


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("d", DIMS)
def test_row_update_kernel_matches_plain_at_int64_ids(dev, m, d):
    """``torch.unique``'s int64 ids straight into the kernel: the same bits
    as int32 ids and as the plain version."""
    rng = np.random.RandomState(m * 1000 + d + 7)
    vocab = 4 * m + 10
    param = torch.from_numpy(rng.randn(vocab, d).astype(np.float32)).to(dev)
    ids = rng.choice(vocab, m, replace=False)
    rows = torch.from_numpy(rng.randn(m, d).astype(np.float32)).to(dev)
    got = {}
    for dtype in (torch.int32, torch.int64):
        got[dtype] = param.clone()
        su.sparse_row_update(got[dtype], torch.from_numpy(ids).to(
            dev, dtype), rows)
    want = su.sparse_row_update_plain(param.clone(), torch.from_numpy(
        ids).to(dev), rows)
    torch.cuda.synchronize()
    assert torch.equal(got[torch.int32], want)
    assert torch.equal(got[torch.int64], want)


@pytest.mark.parametrize("bad", [-1, 40, 2 ** 31 + 3])
def test_row_update_rejects_an_id_outside_the_table(dev, bad):
    """The kernel makes no sync: it skips the bad id, updates the call's
    other rows, and the wrapper's next call on the card raises, before its
    own launch. A call whose every id is outside changes no row."""
    param = torch.zeros(40, 16, device=dev)
    ids = torch.tensor([0, bad, 7], dtype=torch.int64, device=dev)
    before = kernels.launches("sparse_row_update")
    su.sparse_row_update(param, ids, torch.ones(3, 16, device=dev))
    torch.cuda.synchronize()
    assert kernels.launches("sparse_row_update") == before + 1
    with pytest.raises(ValueError, match=f"id {bad} outside"):
        su.sparse_row_update(param, ids[:1], torch.ones(1, 16, device=dev))
    assert kernels.launches("sparse_row_update") == before + 1
    want = torch.zeros(40, 16, device=dev)
    want[[0, 7]] = 1.0
    assert torch.equal(param, want)

    all_bad = torch.tensor([bad, -5, 1 << 40], dtype=torch.int64, device=dev)
    su.sparse_row_update(param, all_bad, torch.ones(3, 16, device=dev))
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="outside"):
        su.raise_pending(dev)
    assert torch.equal(param, want)
    su.raise_pending(dev)                    # reported once, then clear


@pytest.mark.parametrize("fetch", ["numpy", "tensor", "none"])
def test_executor_run_raises_on_an_id_outside_the_table(dev, fetch):
    """Through ``Executor.run`` with the flag on: ``EnforceError`` naming
    ``sgd_sparse`` with the ``ValueError`` naming the id as its cause, as
    the CPU path raises it, by the end of the run — after its fetch copy,
    or after a wait on the stream when nothing is copied (tensor fetches,
    no fetches). The in-range ids' rows are updated and no other row
    changed; the next run is clean."""
    main = sgd_sparse_program(50, 4, 4)
    exe, scope = pt.Executor(), pt.Scope()
    table = torch.randn(50, 4, device=dev)
    start = table.clone()
    scope.set("table", table)
    feed = {"ids": np.array([3, 57, 5, 3], np.int64),
            "rows": np.ones((4, 4), np.float32),
            "lr": np.array([0.5], np.float32)}
    kwargs = {"numpy": dict(fetch_list=["lr"]),
              "tensor": dict(fetch_list=["lr"], return_numpy=False),
              "none": dict(fetch_list=[])}[fetch]
    old = flags.pallas_sparse_update
    flags.pallas_sparse_update = True
    try:
        with pytest.raises(EnforceError, match="sgd_sparse") as info:
            exe.run(main, feed=feed, scope=scope, **kwargs)
        assert isinstance(info.value.__cause__, ValueError)
        assert "id 57 outside" in str(info.value.__cause__)
        want = start.clone()
        want[3] -= 1.0
        want[5] -= 0.5
        assert torch.equal(scope.find_var("table"), want)
        feed["ids"] = np.array([1, 2, 2, 4], np.int64)
        exe.run(main, feed=feed, scope=scope, **kwargs)
    finally:
        flags.pallas_sparse_update = old
    want[1] -= 0.5
    want[2] -= 1.0
    want[4] -= 0.5
    assert torch.equal(scope.find_var("table"), want)


def test_sgd_sparse_makes_one_sync_and_admit_rows_none(dev):
    """One ``sgd_sparse`` with K6 syncs once (``torch.unique``); the id
    range check and the int32 cast are gone. ``admit_rows`` uploads
    through its pinned staging buffer without a sync, fresh or reused."""
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 1000, (64, 3))).to(dev)
    ins = {"Param": [torch.zeros(1000, 16, device=dev)], "Ids": [ids],
           "RowGrad": [torch.ones(64, 3, 16, device=dev)],
           "LearningRate": [torch.full((1,), 0.1, device=dev)]}
    lowering = resolve_op_def("sgd_sparse").lowering()
    old = flags.pallas_sparse_update
    flags.pallas_sparse_update = True
    try:
        before = kernels.launches("sparse_row_update")
        assert _syncs(lambda: lowering(ins, {"padding_idx": -1})) == 1
        assert kernels.launches("sparse_row_update") == before + 1
    finally:
        flags.pallas_sparse_update = old

    slab = torch.zeros(256, 16, device=dev)
    staging = kemb.Staging()
    rows = np.arange(5 * 16, dtype=np.float32).reshape(5, 16)
    for slots in ([3, 9, 0, 255, 17], [4, 5, 6, 7, 8]):
        assert _syncs(lambda: kemb.admit_rows(slab, slots, rows,
                                              staging)) == 0
        torch.cuda.synchronize()
        assert np.array_equal(slab[slots].cpu().numpy(), rows)


@pytest.mark.parametrize("own", [False, True], ids=["card", "own"])
def test_back_to_back_admissions_keep_their_bytes(dev, own):
    """Two admissions through one staging (the card's, or the caller's)
    while the card is still busy: the first one's copy is queued behind a
    sleep, so the second waits for it (counted) before it refills the
    pinned buffer, and both slabs get exactly their rows."""
    rng = np.random.RandomState(9)
    staging = kemb.Staging() if own else None
    slabs = [torch.zeros(512, 16, device=dev) for _ in range(2)]
    slots = [rng.choice(512, 300, replace=False) for _ in range(2)]
    rows = [rng.randn(300, 16).astype(np.float32) for _ in range(2)]
    kemb.admit_rows(slabs[0], slots[0], rows[0], staging)
    torch.cuda.synchronize()           # the buffers exist at the size
    slabs[0].zero_()
    waits = kemb.staging_waits()
    torch.cuda._sleep(50_000_000)
    for slab, s, r in zip(slabs, slots, rows):
        kemb.admit_rows(slab, s, r, staging)
    assert kemb.staging_waits() == waits + 1
    torch.cuda.synchronize()
    for slab, s, r in zip(slabs, slots, rows):
        want = torch.zeros(512, 16)
        want[torch.from_numpy(s)] = torch.from_numpy(r)
        assert torch.equal(slab.cpu(), want)


def test_staging_is_reused_and_grows(dev):
    """One staging buffer across admissions of growing size and on two
    slabs: every admission equals the plain version."""
    rng = np.random.RandomState(5)
    staging = kemb.Staging()
    for cap, dim, n in ((64, 16, 3), (4096, 16, 1000), (4096, 1, 4000),
                        (64, 3, 64), (1 << 16, 16, 5000)):
        slab = torch.from_numpy(rng.randn(cap, dim).astype(np.float32)).to(dev)
        slots = rng.choice(cap, n, replace=False)
        rows = rng.randn(n, dim).astype(np.float32)
        got, want = slab.clone(), slab.clone()
        kemb.admit_rows(got, slots, rows, staging)
        kemb.scatter_rows_plain(want, slots, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_wide_deep_is_bit_identical_across_capacities_on_the_card(dev):
    """6 steps at batch 64: capacity 128 makes every table evict (checked
    on the CPU with the same stream), 4096 holds everything."""
    steps = 6
    records = list(wd.click_log(64 * steps, seed=1))
    runs = []
    for capacity in (128, 4096):
        with unique_name.guard():
            main, startup, feeds, (loss, _p) = wd.build_programs(
                capacity=capacity)
        startup.random_seed = 3
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        engine = EmbeddingEngine(scope=scope)
        kernels.reset_launches()
        losses = []
        for i in range(steps):
            feed = engine.prepare_feed(
                main, wd.make_batch(records[i * 64:(i + 1) * 64], feeds))
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0][0]))
        assert kernels.launches("embedding_admission") >= 8
        runs.append((losses, engine.host_rows(), engine.stats()))
        engine.close()
    (l_small, h_small, st_small), (l_big, h_big, st_big) = runs
    assert all(st["evictions"] > 0 for st in st_small.values()), st_small
    assert not any(st["evictions"] for st in st_big.values())
    assert l_small == l_big
    for t, rows in h_big.items():
        assert set(h_small[t]) == set(rows)
        assert all(h_small[t][i].tobytes() == r.tobytes()
                   for i, r in rows.items()), t
