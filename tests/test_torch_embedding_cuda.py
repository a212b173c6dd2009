"""The embedding admission kernel (K5) and the sparse row update kernel
(K6) against their plain versions on the card, at ragged sizes (M = 1, 3,
257 rows; D = 1, 3, 16, 129), with the drop slot, id 0 among the ids with
fill rows past the unique count, a slot outside the slab and an id
outside the table raising before the launch, and the in-place update of a scope's tensor; then a small
Wide&Deep run on the card, bit-identical across cache capacities. Marked
``cuda``: it skips without a card and runs on one with

    python -m pytest -m cuda tests/test_torch_embedding_cuda.py -q

Both kernels only move or add each element once, so the bar is bit
equality with the plain versions.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels
from paddle_tpu_torch.embedding import EmbeddingEngine
from paddle_tpu_torch.kernels import embedding as kemb
from paddle_tpu_torch.kernels import sparse_update as su
from paddle_tpu_torch.models import wide_deep as wd
from paddle_tpu_torch.utils import unique_name

pytestmark = pytest.mark.cuda

ROWS = (1, 3, 257)
DIMS = (1, 3, 16, 129)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


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


@pytest.mark.parametrize("bad", [-1, 40, 2 ** 31 + 3])
def test_row_update_rejects_an_id_outside_the_table(dev, bad):
    param = torch.zeros(40, 16, device=dev)
    ids = torch.tensor([0, bad, 7], dtype=torch.int64, device=dev)
    before = kernels.launches("sparse_row_update")
    with pytest.raises(ValueError, match="outside"):
        su.sparse_row_update(param, ids, torch.ones(3, 16, device=dev))
    assert kernels.launches("sparse_row_update") == before
    assert not param.any()


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
        exe, scope = pt.Executor(seed=3), pt.Scope()
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
