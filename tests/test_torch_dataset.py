"""The port's ``Dataset`` (``paddle_tpu_torch/dataset.py``) on its own copy
of the native MultiSlot feed, against its Python fallback and against the
JAX package's ``Dataset`` on the same files:

* the port builds its native feed from ``native/csrc/datafeed.cc`` (a
  byte-for-byte copy of the JAX package's ``csrc/datafeed/datafeed.cc``)
  into its own build directory, never beside the JAX source;
* batches bit-equal (dtype, shape, bytes) between the native feed,
  ``_PyFeed`` and the JAX ``Dataset``, fixed and variable-length slots,
  ``set_pad_to`` truncation counts and ``<name>.lens`` included; the
  ``local_shuffle(seed)`` order; ``global_shuffle`` partitions over two
  simulated ranks sharing an exchange directory; ``num_workers`` 0 and 3;
* data written by the port's ``MultiSlotDataGenerator`` equals the JAX
  generator's lines;
* ``train_from_dataset`` (Hogwild, through the prefetcher) equals
  ``exe.run`` over the same batches, and the JAX package's
  ``train_from_dataset`` from the same start (losses within rtol 1e-5,
  atol 1e-6); ``infer_from_dataset`` refuses a training program, runs the
  test clone; ``FetchHandler`` in the loop and ``background=True``
  through ``FetchHandlerMonitor``.
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.dataset import _NativeFeed as JaxNativeFeed
from paddle_tpu.incubate.data_generator import (
    MultiSlotDataGenerator as JaxGenerator)
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch import native
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.dataset import _NativeFeed, _PyFeed
from paddle_tpu_torch.incubate.data_generator import MultiSlotDataGenerator
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.observability.fetcher import FetchHandlerMonitor
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.enforce import EnforceError

ROOT = Path(__file__).resolve().parents[1]


def _files(tmp_path, n_files=3, rows=23, seed=0):
    """MultiSlot files: ids (2), w (1 float), seq (1-5 ids)."""
    r = np.random.RandomState(seed)
    paths = []
    for f in range(n_files):
        lines = []
        for i in range(rows):
            k = r.randint(1, 6)
            seq = " ".join(str(r.randint(0, 2 ** 40)) for _ in range(k))
            lines.append(f"2 {f} {r.randint(0, 1000)} 1 {r.rand():.6f} "
                         f"{k} {seq}")
        p = tmp_path / f"part-{f}.txt"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    return paths


def _dataset(mod, paths, native_feed=True, kind="InMemoryDataset", bs=8,
             workers=0, pad_to=None, lens=True):
    main = mod.Program()
    with mod.program_guard(main, mod.Program()):
        vars_ = [mod.data("ids", shape=[-1, 2], dtype="int64"),
                 mod.data("w", shape=[-1, 1]),
                 mod.data("seq", shape=[-1, -1], dtype="int64")]
    ds = mod.DatasetFactory().create_dataset(kind)
    ds._use_native = native_feed
    ds.set_batch_size(bs)
    ds.set_thread(2)
    ds.set_num_workers(workers)
    ds.set_use_var(vars_)
    ds.set_filelist(paths)
    ds.set_emit_lengths(lens)
    if pad_to:
        ds.set_pad_to(pad_to)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
    return ds


def _same(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            assert x[k].shape == y[k].shape, k
            assert x[k].tobytes() == y[k].tobytes(), k


def test_the_native_feed_builds_from_the_ports_copy():
    port = (native.CSRC / "datafeed.cc").read_bytes()
    assert port == (ROOT / "csrc" / "datafeed" / "datafeed.cc").read_bytes()
    assert (native.CSRC / "ps.cc").read_bytes() == \
        (ROOT / "csrc" / "ps" / "ps.cc").read_bytes()
    native.load_native("datafeed")
    lib = native.library_path("datafeed")
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.is_relative_to(ROOT / "paddle_tpu_torch")


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("pad_to", [None, {"seq": 2}])
def test_batches_equal_the_python_feed_and_the_jax_dataset(tmp_path, workers,
                                                           pad_to):
    paths = _files(tmp_path)
    port = _dataset(pt, paths, workers=workers, pad_to=pad_to)
    assert port.native_feed and isinstance(port._feed, _NativeFeed)
    got = list(port._iter_batches())
    py = list(_dataset(pt, paths, native_feed=False, pad_to=pad_to)
              ._iter_batches())
    jds = _dataset(fluid, paths, pad_to=pad_to)
    assert isinstance(jds._feed, JaxNativeFeed)
    _same(got, py)
    _same(got, list(jds._iter_batches()))
    assert len(got) == 9 and got[-1]["ids"].shape == (5, 2)
    assert port.truncated_row_counts() == jds.truncated_row_counts()
    if pad_to:
        assert port.truncated_row_counts()["seq"] > 0


def test_local_shuffle_and_queue_dataset_follow_the_jax_ones(tmp_path):
    paths = _files(tmp_path)
    out = []
    for mod in (fluid, pt):
        ds = _dataset(mod, paths)
        ds.local_shuffle(seed=5)
        first = [b["ids"].copy() for b in ds._iter_batches()]
        ds.local_shuffle(seed=6)        # composes onto the permutation
        second = [b["ids"].copy() for b in ds._iter_batches()]
        q = _dataset(mod, paths, kind="QueueDataset")
        with pytest.raises(RuntimeError, match="does not support shuffle"):
            q.local_shuffle(1)
        out.append((first, second, list(q._iter_batches())))
    for a, b in zip(out[0][:2], out[1][:2]):
        assert [x.tobytes() for x in a] == [x.tobytes() for x in b]
    assert [x.tobytes() for x in out[1][0]] != \
        [x.tobytes() for x in out[1][1]]
    _same(out[1][2], out[0][2])


class _Rank:
    def __init__(self, r):
        self.r = r

    def worker_index(self):
        return self.r

    def worker_num(self):
        return 2


def _global_shuffle(mod, paths, exchange):
    dss = [_dataset(mod, paths[r::2]) for r in range(2)]
    errors = []

    def run(r):
        try:
            dss[r].global_shuffle(fleet=_Rank(r), seed=3,
                                  exchange_dir=str(exchange))
        except Exception as e:       # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return [list(ds._iter_batches()) for ds in dss]


def test_global_shuffle_partitions_as_the_jax_dataset(tmp_path):
    paths = _files(tmp_path, n_files=4)
    want = _global_shuffle(fluid, paths, tmp_path / "jx")
    got = _global_shuffle(pt, paths, tmp_path / "pt")
    for g, w in zip(got, want):
        _same(g, w)
    rows = sorted(tuple(r) for part in got for b in part for r in b["ids"])
    assert len(rows) == 4 * 23 == len(set(rows))


def test_the_generators_write_the_same_lines(tmp_path):
    lines = [f"{i} {i * 7 % 13}" for i in range(40)]

    def make(base):
        class G(base):
            def generate_sample(self, line):
                def it():
                    a, b = (int(x) for x in line.split())
                    if a % 9 == 4:
                        yield None
                        return
                    yield [("ids", [a, b]), ("w", [a / 7.0])]
                return it
        return G()

    want = make(JaxGenerator).run_from_memory(lines)
    got = make(MultiSlotDataGenerator).run_from_memory(lines)
    assert got == want and len(got) == 36
    g = make(MultiSlotDataGenerator)
    g.set_batch(4)
    src, out = tmp_path / "raw.txt", tmp_path / "ms.txt"
    src.write_text("\n".join(lines) + "\n")
    g.run_from_file(str(src), str(out))
    assert out.read_text().splitlines() == want


# ---------------------------------------------------------------------------
# train_from_dataset / infer_from_dataset
# ---------------------------------------------------------------------------


def _regression_files(tmp_path, n=64, seed=1):
    r = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        x = r.rand(4)
        lines.append("4 " + " ".join(f"{v:.5f}" for v in x)
                     + f" 1 {x.sum():.5f}")
    p = tmp_path / "reg.txt"
    p.write_text("\n".join(lines) + "\n")
    return [str(p)]


def _regression(mod):
    names = jax_names if mod is fluid else torch_names
    with names.guard():
        main, startup = mod.Program(), mod.Program()
        with mod.program_guard(main, startup):
            x = mod.data("x", shape=[-1, 4])
            y = mod.data("y", shape=[-1, 1])
            pred = mod.layers.fc(x, size=1)
            loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
            test = main.clone(for_test=True)
            mod.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, test, [x, y], loss


def _reg_dataset(mod, feed_vars, paths):
    ds = mod.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(16)
    ds.set_use_var(feed_vars)
    ds.set_filelist(paths)
    ds.load_into_memory()
    ds.local_shuffle(seed=1)
    return ds


class _Tap(pt.FetchHandler):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen = []

    def handler(self, fetch_vars):
        self.seen.append({k: np.asarray(v).copy()
                          for k, v in fetch_vars.items()})


def test_train_from_dataset_equals_exe_run_and_the_jax_loop(tmp_path):
    paths = _regression_files(tmp_path)
    jmain, jstart, _t, jvars, jloss = _regression(fluid)
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = fluid.Scope()
    want = []
    with fluid.scope_guard(jscope):
        jexe.run(jstart)
        state = {v.name: np.asarray(jscope.find_var(v.name))
                 for v in jstart.global_block().vars.values() if v.persistable}

        class JTap(fluid.FetchHandler):
            def handler(self, fv):
                want.append(float(np.asarray(fv[jloss.name]).reshape(-1)[0]))

        for _ in range(3):
            jexe.train_from_dataset(jmain, _reg_dataset(fluid, jvars, paths),
                                    fetch_list=[jloss],
                                    fetch_handler=JTap(period_secs=0))

    main, startup, _test, feed_vars, loss = _regression(pt)
    exe = pt.Executor(place=pt.CPUPlace())
    runs = {}
    for arm in ("dataset", "run"):
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        load_params(scope, state)
        runs[arm] = scope
    ds = _reg_dataset(pt, feed_vars, paths)
    tap = _Tap(period_secs=0)
    waits = registry().histogram("dataio_consumer_wait_seconds",
                                 labels={"pipeline": "train_from_dataset"})
    before = waits.count
    for _ in range(3):
        last = exe.train_from_dataset(main, ds, scope=runs["dataset"],
                                      fetch_list=[loss], fetch_handler=tap)
    got = [float(v[loss.name].reshape(-1)[0]) for v in tap.seen]
    ref = []
    for _ in range(3):
        for b in ds._iter_batches():
            ref.append(float(exe.run(main, feed=b, fetch_list=[loss],
                                     scope=runs["run"])[0][0]))
    assert got == ref and len(got) == 12
    assert float(last[0][0]) == got[-1]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[-1] < got[0]
    # the batches went through the prefetcher: its waits, one a batch
    # and one for the end of each pass, reach the registry
    assert waits.count - before == 3 * (4 + 1)


def test_infer_from_dataset_refuses_a_training_program(tmp_path):
    paths = _regression_files(tmp_path)
    main, startup, test, feed_vars, loss = _regression(pt)
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    ds = _reg_dataset(pt, feed_vars, paths)
    with pytest.raises(EnforceError, match="for_test"):
        exe.infer_from_dataset(main, ds, scope=scope, fetch_list=[loss])
    w = scope.find_var("fc_0.w_0").clone()
    out = exe.infer_from_dataset(test, ds, scope=scope, fetch_list=[loss])
    assert np.isfinite(out[0]).all()
    assert scope.find_var("fc_0.w_0").equal(w)      # nothing trained


def test_a_background_fetch_handler_delivers_from_the_monitor(tmp_path):
    paths = _regression_files(tmp_path, n=160)
    main, startup, _test, feed_vars, loss = _regression(pt)
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    tap = _Tap(period_secs=0.01, background=True)
    exe.train_from_dataset(main, _reg_dataset(pt, feed_vars, paths),
                           scope=scope, fetch_list=[loss], fetch_handler=tap)
    # the monitor's final tick delivers the last published fetch
    assert tap.seen and set(tap.seen[-1]) == {loss.name}


def test_fetch_handler_monitor_cadence_and_a_raising_handler():
    class H:
        period_secs = 0.02

        def __init__(self):
            self.got = []

        def handler(self, v):
            self.got.append(v["loss"])
            if len(self.got) == 1:
                raise RuntimeError("a user handler may raise")

    h = H()
    mon = FetchHandlerMonitor(h).start()
    for i in range(5):
        mon.update({"loss": i})
        time.sleep(0.05)
    mon.stop()
    assert len(h.got) >= 3 and h.got[-1] == 4
    assert mon.deliveries == len(h.got) - 1       # the raising one
    assert mon._lock.name == "observability.fetcher"
