"""Wide&Deep over the embedding engine in the PyTorch port against the
JAX package, at a small size on the CPU: ``models/wide_deep.py`` (the JAX
example's programs) at batch 32 and capacity 64, so that every table
evicts, for 10 click-log steps, from the JAX startup's state. Engine stats
exactly, the loss stream within rtol 1e-5 / atol 1e-6, and after a flush
the host tier and every persistable within atol 1e-6 — against the JAX
engine in its ``auto`` mode (composite admission on the CPU) and its
``interpret`` mode (the Pallas admission kernel); the port admits through
K5's plain version (CPU tensors).

Both builds use ``min_bucket=64``, so every table's slot feed has 64 rows
and the JAX step compiles once per mode (the bucket logic at the default
``min_bucket`` runs in ``test_torch_embedding.py``'s invariance test).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import kernels as jax_kernels
from paddle_tpu.embedding import EmbeddingEngine as JaxEngine
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.embedding import EmbeddingEngine
from paddle_tpu_torch.models import wide_deep as torch_wd
from paddle_tpu_torch.utils import unique_name as torch_names

ROOT = Path(__file__).resolve().parents[1]
BATCH, CAPACITY, STEPS, BUCKET = 32, 64, 10, 64


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "wide_deep_example", ROOT / "examples" / "wide_deep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_COUNTERS = {"hits": "embedding_cache_hits_total",
             "misses": "embedding_cache_misses_total",
             "evictions": "embedding_cache_evictions_total",
             "writebacks": "embedding_writebacks_total"}


def _jax_counts(table):
    """The JAX engine's counters live in a process-wide registry, so a
    run's stats are deltas of them."""
    reg = jax_metrics.registry()
    out = {}
    for key, fam in _COUNTERS.items():
        m = reg.get(fam, {"table": table})
        out[key] = m.value if m is not None else 0
    return out


def _jax_wide_deep(monkeypatch, mode, batches):
    example = _jax_example()
    real = fluid.layers.sharded_embedding

    def sized(*a, **k):
        return real(*a, **dict(k, capacity=CAPACITY, min_bucket=BUCKET))

    monkeypatch.setattr(fluid.layers, "sharded_embedding", sized)
    with jax_names.guard():
        main, startup, feeds, (loss, _pred) = example.build_programs(
            fluid.Program(), fluid.Program())
    monkeypatch.setattr(fluid.layers, "sharded_embedding", real)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope), jax_kernels.scoped_mode(mode):
        exe.run(startup)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in startup.global_block().vars.values()
                 if v.persistable}
        engine = JaxEngine(scope=scope)
        tables = sorted(main._sharded_tables)
        before = {t: _jax_counts(t) for t in tables}
        losses = []
        for batch in batches:
            feed = engine.prepare_feed(main, dict(batch))
            losses.append(float(np.asarray(exe.run(
                main, feed=feed, fetch_list=[loss])[0]).reshape(-1)[0]))
        engine.flush()
        stats = {}
        for t, st in engine.stats().items():
            after = _jax_counts(t)
            st = dict(st, **{k: after[k] - before[t][k] for k in after})
            st["hit_rate"] = st["hits"] / max(1, st["hits"] + st["misses"])
            stats[t] = st
        host = {t: {i: r.copy() for shard in rt.store._shards
                    for i, r in shard.items()}
                for t, rt in engine.tables.items()}
        final = {n: np.asarray(scope.find_var(n)) for n in state
                 if main.global_block().has_var(n)}
        engine.close()
    return dict(state=state, losses=losses, stats=stats, host=host,
                final=final)


def _torch_wide_deep(batches, capacity=CAPACITY, min_bucket=BUCKET,
                     state=None):
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


@pytest.mark.parametrize("mode", ["auto", "interpret"])
def test_wide_deep_matches_jax(monkeypatch, batches, mode):
    """The JAX engine admits through its composite scatter (``auto`` on the
    CPU) or its Pallas kernel in interpret mode; the port through K5's
    plain version. Both trains start from the JAX startup's state. Float32
    sums run in another order in the two packages' dense layers, so the
    trained values agree to rounding (atol 1e-6), not bit for bit."""
    want = _jax_wide_deep(monkeypatch, mode, batches)
    got = _torch_wide_deep(batches, state=want["state"])
    assert got["stats"] == want["stats"]
    assert all(st["evictions"] > 0 and st["writebacks"] > 0
               for st in got["stats"].values()), got["stats"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    assert set(got["host"]) == set(want["host"]) and len(got["host"]) == 8
    for t, rows in want["host"].items():
        assert set(got["host"][t]) == set(rows), t
        for i, row in rows.items():
            np.testing.assert_allclose(got["host"][t][i], row, rtol=0,
                                       atol=1e-6, err_msg=f"{t}[{i}]")
    assert set(got["final"]) == set(want["final"])
    for n, w in want["final"].items():
        np.testing.assert_allclose(got["final"][n], w, rtol=0, atol=1e-6,
                                   err_msg=n)
    moved = [n for n in want["final"]
             if not np.array_equal(want["final"][n], want["state"][n])]
    assert len(moved) > 8, moved          # the slabs and the dense layers
