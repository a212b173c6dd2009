"""The port's DataLoader (``paddle_tpu_torch/reader/dataloader.py``)
against the JAX package's on the same generators:

* ``set_sample_generator`` (with a ``sample_transform``),
  ``set_sample_list_generator`` and ``set_batch_generator`` give the
  JAX loader's batch stream, value for value, for ``num_workers`` 0 and
  2 (the JAX loader's int64 feeds land as int32 on its device; the port
  keeps the declared type, so values are compared, and the port's dtypes
  against the declarations); ``return_list`` and ``PyReader`` too;
* placement: a feed the host reads (a sharded table's raw ids) stays a
  numpy array, every other feed is a tensor on ``places``;
* a batch generator's bad shape, dtype or missing key raises by name,
  with the JAX loader's message;
* a tiny Wide&Deep (``test_torch_wide_deep.py``'s sizes, 4 steps) fed
  through each package's loader from the JAX startup's state: the losses
  within that file's bars (rtol 1e-5, atol 1e-6). The click log's ids
  are folded under 2^31 for it: the JAX loader device-puts the raw ids
  too, as int32 (64-bit types off), which wraps a larger id onto another
  row; the port's loader keeps them on the host as int64.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.models import wide_deep as torch_wd
from paddle_tpu_torch.utils import unique_name as torch_names
from test_torch_wide_deep import (BATCH, BUCKET, CAPACITY, _jax_example,
                                  _jax_wide_deep, _torch_wide_deep)

CPU = pt.CPUPlace()


def _vars(mod):
    main = mod.Program()
    with mod.program_guard(main, mod.Program()):
        x = mod.data("x", shape=[-1, 4])
        y = mod.data("y", shape=[-1, 1], dtype="int64")
    return [x, y]


def _samples(n=30, seed=0):
    def gen():
        r = np.random.RandomState(seed)
        for _ in range(n):
            xv = r.rand(4)                           # float64: cast
            yield xv, int(r.randint(0, 9))
    return gen


def _plus_one(sample):
    x, y = sample
    return x + 1.0, y


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_stream(got, want, dtypes):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(g, dict):
            assert sorted(g) == sorted(w)
            keys = list(w)
        else:
            keys = range(len(w))
        for k in keys:
            gv, wv = _host(g[k]), np.asarray(w[k])
            assert gv.shape == wv.shape
            np.testing.assert_array_equal(gv, wv.astype(gv.dtype))
            assert gv.dtype == dtypes[k], (k, gv.dtype)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("how", ["sample", "sample_list", "batch"])
def test_batch_stream_equals_the_jax_loaders(num_workers, how):
    streams = {}
    for name, mod in (("jax", fluid), ("torch", pt)):
        loader = mod.DataLoader.from_generator(
            feed_list=_vars(mod), capacity=3, num_workers=num_workers)
        kw = {"places": CPU} if mod is pt else {}
        if how == "sample":
            loader.set_sample_generator(_samples(), 8, drop_last=False,
                                        sample_transform=_plus_one, **kw)
        elif how == "sample_list":
            loader.set_sample_list_generator(
                mod.reader.batch(_samples(), 7), **kw)
        else:
            def batches():
                r = np.random.RandomState(3)
                for _ in range(5):
                    yield {"x": r.rand(6, 4).astype(np.float32),
                           "y": r.randint(0, 9, (6, 1)).astype(np.int32)}
            loader.set_batch_generator(batches, **kw)
        streams[name] = list(loader)
    _same_stream(streams["torch"], streams["jax"],
                 {"x": np.float32, "y": np.int64})


def test_return_list_and_pyreader_follow_the_jax_ones():
    got, want = [], []
    for mod, out in ((fluid, want), (pt, got)):
        loader = mod.DataLoader.from_generator(
            feed_list=_vars(mod), capacity=2, return_list=True)
        kw = {"places": CPU} if mod is pt else {}
        loader.set_sample_generator(_samples(12), 4, **kw)
        out.extend(loader)
        reader = mod.PyReader(feed_list=_vars(mod), capacity=2)
        reader.decorate_sample_list_generator(
            mod.reader.batch(_samples(9), 3), **kw)
        reader.start()
        while True:
            try:
                out.append(reader.next())
            except StopIteration:
                break
    assert len(got) == len(want) == 6
    _same_stream(got[:3], want[:3], {0: np.float32, 1: np.int64})
    _same_stream(got[3:], want[3:], {"x": np.float32, "y": np.int64})


@pytest.mark.parametrize("batch,match", [
    ({"x": np.zeros((2, 5), np.float32), "y": np.zeros((2, 1), np.int64)},
     "'x'.*shape mismatch"),
    ({"x": np.zeros((2, 4), np.int64), "y": np.zeros((2, 1), np.int64)},
     "'x'.*dtype mismatch"),
])
def test_a_bad_batch_raises_by_name_as_in_jax(batch, match):
    msgs = []
    for mod in (fluid, pt):
        loader = mod.DataLoader.from_generator(feed_list=_vars(mod))
        loader.set_batch_generator(lambda: iter([batch]),
                                   **({"places": CPU} if mod is pt else {}))
        with pytest.raises(ValueError, match=match) as ei:
            list(loader)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    loader = pt.DataLoader.from_generator(feed_list=_vars(pt))
    loader.set_batch_generator(lambda: iter([{"z": np.zeros(2)}]),
                               places=CPU)
    with pytest.raises(Exception, match="missing feed variable"):
        list(loader)


def test_host_read_ids_stay_numpy_and_the_rest_are_tensors():
    with torch_names.guard():
        main, _s, feeds, _ = torch_wd.build_programs(capacity=CAPACITY)
    records = list(torch_wd.click_log(3 * BATCH, seed=4))
    direct = [torch_wd.make_batch(records[i * BATCH:(i + 1) * BATCH], feeds)
              for i in range(3)]
    for workers in (0, 2):
        got = list(torch_wd.make_loader(main, feeds, lambda: iter(records),
                                        BATCH, num_workers=workers,
                                        places=CPU))
        assert len(got) == 3
        for g, d in zip(got, direct):
            for n in feeds:
                ids = n.startswith("slot_") and not n.endswith("_w")
                assert isinstance(g[n], np.ndarray if ids else torch.Tensor), n
                gv = _host(g[n])
                assert gv.dtype == d[n].dtype and gv.tobytes() == d[n].tobytes()


def _under_2_31(rec):
    return {"slots": {k: [i % (2 ** 31 - 1) for i in v]
                      for k, v in rec["slots"].items()},
            "click": rec["click"]}


def test_wide_deep_through_both_loaders(monkeypatch):
    steps = 4
    records = [_under_2_31(r) for r in torch_wd.click_log(BATCH * steps,
                                                          seed=0)]
    example = _jax_example()
    with jax_names.guard():
        jmain, _js, jfeeds, _ = example.build_programs(fluid.Program(),
                                                       fluid.Program())
    transform = fluid.dataio.make_sparse_batch_transform(
        [f"slot_{i}" for i in range(torch_wd.NUM_SLOTS)],
        torch_wd.IDS_PER_SLOT)
    jax_loader = fluid.reader.DataLoader.from_generator(
        feed_list=[jmain.global_block().var(n) for n in jfeeds], capacity=4,
        num_workers=2,
    ).set_sample_generator(lambda: iter(records), BATCH,
                           sample_transform=transform)
    want = _jax_wide_deep(monkeypatch, "auto", jax_loader)
    with torch_names.guard():
        main, _s, feeds, _ = torch_wd.build_programs(capacity=CAPACITY,
                                                     min_bucket=BUCKET)
    loader = torch_wd.make_loader(main, feeds, lambda: iter(records), BATCH,
                                  places=CPU)
    got = _torch_wide_deep(loader, state=want["state"])
    assert len(got["losses"]) == len(want["losses"]) == steps
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
