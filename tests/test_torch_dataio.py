"""The port's data engine (``paddle_tpu_torch/dataio/``) against the JAX
package's on the same sources:

* ``DataEngine`` (a per-sample random transform, batches) and
  ``parallel_map_ordered`` streams equal to the JAX package's, for
  ``num_workers`` 0, 2 and 4;
* sharded sources: disjoint, complete shards, each rank's state dict
  equal to the JAX one's;
* ``elastic=True``: four ranks consume part of an epoch, two ranks
  resume from their state dicts, and the epoch is consumed exactly once
  — the same positions as the JAX engines';
* the ``DevicePrefetcher`` (on the CPU here): order, values, the host
  keys kept as numpy, the ``specs`` cast, errors at their position, the
  consumer-exact state proxy, and a rank's rows under a 2-rank plan
  equal to the JAX prefetcher's shard of that rank;
* a JAX ``AutoCheckpoint(data_state=engine)`` directory resumes the
  port's ``DataEngine`` (and a ``DevicePrefetcher`` over one) at the
  same cursor, with the JAX continuation stream bit for bit;
* the ``dataio.read`` fault site on the port's injector.
"""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.dataio import DataEngine as JaxEngine
from paddle_tpu.dataio import DevicePrefetcher as JaxPrefetcher
from paddle_tpu.dataio import ListSource as JaxList
from paddle_tpu.dataio import parallel_map_ordered as jax_pmap
from paddle_tpu.incubate.checkpoint import AutoCheckpoint as JaxCheckpoint
from paddle_tpu_torch.dataio import (
    DataEngine,
    DevicePrefetcher,
    FileSource,
    ListSource,
    parallel_map_ordered,
)
from paddle_tpu_torch.incubate import checkpoint as ckpt
from paddle_tpu_torch.resilience import faults

CPU = torch.device("cpu")


def _aug(x, rng):
    return (x, rng.randint(0, 10 ** 9), round(rng.random(), 12))


def _streams(num_workers, n=37, bs=5, epochs=2, seed=7):
    out = []
    for List, Engine in ((JaxList, JaxEngine), (ListSource, DataEngine)):
        eng = Engine(List(list(range(n)), seed=seed), transform=_aug,
                     batch_size=bs, num_workers=num_workers)
        out.append([[list(b) for b in eng] for _ in range(epochs)])
    return out


@pytest.mark.parametrize("num_workers", [0, 2, 4])
def test_engine_stream_equals_the_jax_one(num_workers):
    want, got = _streams(num_workers)
    assert got == want
    assert got[0] != got[1]                 # the epochs differ
    assert _streams(0)[1] == got            # and no worker count matters


@pytest.mark.parametrize("num_workers", [0, 2, 4])
def test_parallel_map_ordered_equals_the_jax_one(num_workers):
    def f(x):
        time.sleep((x % 3) * 1e-4)           # out-of-order finishes
        return x * x - 1

    items = list(range(41))
    assert (list(parallel_map_ordered(iter(items), f, num_workers))
            == list(jax_pmap(iter(items), f, num_workers))
            == [f(x) for x in items])

    def boom(x):
        if x == 6:
            raise KeyError("six")
        return x

    got = []
    with pytest.raises(KeyError, match="six"):
        for v in parallel_map_ordered(iter(items), boom, num_workers):
            got.append(v)
    assert got == list(range(6))


def test_shards_are_disjoint_with_the_jax_state_dicts():
    world = 4
    seen = []
    for r in range(world):
        jsrc = JaxList(list(range(21)), seed=3, rank=r, world=world)
        tsrc = ListSource(list(range(21)), seed=3, rank=r, world=world)
        assert tsrc.epoch_shard(2) == jsrc.epoch_shard(2)
        assert len(tsrc.epoch_shard(2)) == 6
        seen.extend(tsrc.epoch_shard(2))
        jeng = JaxEngine(jsrc, batch_size=2)
        teng = DataEngine(tsrc, batch_size=2)
        ji, ti = iter(jeng), iter(teng)
        for _ in range(2):
            assert next(ti) == next(ji)
        assert teng.state_dict() == jeng.state_dict()
    assert set(seen) == set(range(21)) and len(seen) - len(set(seen)) == 3


def _elastic(List, Engine, num_workers, n=96, bs=4, taken=3):
    """4 ranks take ``taken`` batches each; 2 ranks resume elastically
    from ranks 0 and 1's states; returns the epoch positions consumed
    before and after the resize."""
    before, states = [], []
    for r in range(4):
        eng = Engine(List(list(range(n)), seed=9, rank=r, world=4),
                     batch_size=bs, num_workers=num_workers)
        it = iter(eng)
        for _ in range(taken):
            before.extend(next(it))
        it.close()
        states.append(eng.state_dict())
    after = []
    for r in range(2):
        eng = Engine(List(list(range(n)), seed=9, rank=r, world=2),
                     batch_size=bs, num_workers=num_workers, elastic=True)
        eng.load_state_dict(states[r])
        after.extend(x for b in eng for x in b)
        assert eng.epoch == 1
    return before, after, states


@pytest.mark.parametrize("num_workers", [0, 2])
def test_elastic_resume_4_to_2_exactly_once(num_workers):
    jb, ja, jstates = _elastic(JaxList, JaxEngine, num_workers)
    tb, ta, tstates = _elastic(ListSource, DataEngine, num_workers)
    assert tstates == jstates
    assert tb == jb and ta == ja
    assert sorted(tb + ta) == list(range(96))       # each sample once


def test_file_source_and_the_read_fault_site(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("\n".join(f"1 {i}" for i in range(10)) + "\n\n")
    src = FileSource([str(p)], parse=lambda l: int(l.split()[1]),
                     shuffle=False)
    assert list(DataEngine(src)) == list(range(10))
    faults.configure([{"site": "dataio.read", "action": "raise",
                       "at_step": 4}])
    try:
        eng = DataEngine(FileSource([str(p)], parse=lambda l: int(l.split()[1]),
                                    shuffle=False),
                         skip_errors=True, name="p-read-fault")
        assert list(eng) == [i for i in range(10) if i != 4]
    finally:
        faults.reset()


# ---------------------------------------------------------------------------
# the prefetcher
# ---------------------------------------------------------------------------


def test_prefetcher_order_values_host_keys_and_cast():
    feeds = [{"x": np.full((2, 3), i, np.float64),
              "ids": np.array([[i, i + 1]], np.int64),
              "y": np.array([i], np.int32)} for i in range(6)]
    specs = {"x": ("float32", [-1, 3]), "y": ("int64", [-1])}
    out = list(DevicePrefetcher(iter(feeds), depth=2, device=CPU,
                                host_keys={"ids"}, specs=specs,
                                name="pf-t"))
    assert len(out) == 6
    for i, item in enumerate(out):
        assert isinstance(item["x"], torch.Tensor)
        assert item["x"].dtype == torch.float32 and item["x"].device == CPU
        assert item["y"].dtype == torch.int64
        assert isinstance(item["ids"], np.ndarray)
        np.testing.assert_array_equal(item["x"].numpy(), feeds[i]["x"])
        np.testing.assert_array_equal(item["ids"], feeds[i]["ids"])


def test_prefetcher_raises_at_the_producers_position():
    def gen():
        yield {"x": np.zeros(2, np.float32)}
        raise ValueError("upstream died")

    it = iter(DevicePrefetcher(gen(), depth=2, device=CPU))
    next(it)
    with pytest.raises(ValueError, match="upstream died"):
        next(it)


def test_prefetcher_state_proxy_is_consumer_exact():
    def make():
        return DataEngine(ListSource(list(range(24)), seed=6),
                          batch_size=4, num_workers=2)

    eng = make()
    pre = DevicePrefetcher(eng, depth=3, device=CPU)
    it = iter(pre)
    [next(it) for _ in range(2)]
    time.sleep(0.3)                        # the producer runs ahead
    st = pre.state_dict()
    assert st["emitted_batches"] == 2 and st["cursor"] == 8, st
    assert eng.emitted_batches > 2
    assert pre.global_cursor() == 8
    rest = [b for b in it]
    pre2 = DevicePrefetcher(make(), depth=3, device=CPU)
    pre2.load_state_dict(st)
    assert [b for b in pre2] == rest


def test_a_ranks_rows_equal_the_jax_prefetchers_shard():
    import jax

    from paddle_tpu.parallel.env import make_mesh

    mesh = make_mesh((2,), ("dp",), devices=jax.devices()[:2])
    feed = {"x": np.arange(24, dtype=np.float32).reshape(8, 3),
            "odd": np.arange(3, dtype=np.float32),
            "s": np.float32(3.0)}
    (jax_out,) = list(JaxPrefetcher(iter([feed]), mesh=mesh, batch_axis="dp"))
    for rank in range(2):
        (got,) = list(DevicePrefetcher(iter([feed]), device=CPU, rank=rank,
                                       world=2))
        shard = [s for s in jax_out["x"].addressable_shards
                 if s.device == jax.devices()[rank]][0]
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(shard.data))
        # not batch-shaped along the axis: whole (the JAX replication)
        np.testing.assert_array_equal(got["odd"].numpy(), feed["odd"])
        assert float(got["s"]) == 3.0


# ---------------------------------------------------------------------------
# resume from a JAX AutoCheckpoint
# ---------------------------------------------------------------------------


def _tf(i):
    xv = np.full(4, float(i), np.float32) * 0.1
    return (xv, np.array([xv.sum()], np.float32))


@pytest.mark.parametrize("wrap", ["engine", "prefetcher"])
def test_a_jax_checkpoint_resumes_the_ports_engine(tmp_path, wrap):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[-1, 4])
        y = fluid.data("y", shape=[-1, 1])
        pred = fluid.layers.fc(x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
        feeder = fluid.DataFeeder([x, y])
    exe = fluid.Executor(fluid.CPUPlace())
    d = str(tmp_path / "ck")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        eng = JaxEngine(JaxList(list(range(40)), seed=4), transform=_tf,
                        batch_size=4, num_workers=2)
        ck = JaxCheckpoint(exe, main, d, save_interval_steps=3,
                           data_state=eng)
        it = iter(eng)
        for step in range(5):
            exe.run(main, feed=feeder.feed(next(it)), fetch_list=[loss])
            ck.maybe_save(step, blocking=True)
        it.close()
        ck.close()
    st = ckpt.load_data_state(d)
    jax_eng = JaxEngine(JaxList(list(range(40)), seed=4), transform=_tf,
                        batch_size=4, num_workers=2)
    jax_eng.load_state_dict(st)
    want = [b for b in jax_eng]

    port = DataEngine(ListSource(list(range(40)), seed=4), transform=_tf,
                      batch_size=4, num_workers=2)
    target = port if wrap == "engine" else DevicePrefetcher(port, device=CPU)
    ckpt.load_checkpoint(d, scope=pt.Scope(), data_state=target)
    done = port.emitted_batches
    assert 0 < done == st["emitted_batches"] < 5
    assert port.cursor == st["cursor"] == 4 * done
    got = list(target)
    assert len(got) == len(want) == 10 - done
    for g, w in zip(got, want):
        for (ga, gb), (wa, wb) in zip(g, w):
            ga = ga.numpy() if isinstance(ga, torch.Tensor) else ga
            gb = gb.numpy() if isinstance(gb, torch.Tensor) else gb
            assert ga.tobytes() == wa.tobytes() and gb.tobytes() == wb.tobytes()
