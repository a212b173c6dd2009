"""Wide&Deep CTR over the sharded embedding engine, copied from the JAX
package's ``examples/wide_deep.py`` (``build_programs``, ``click_log``):

* sparse features ride ``layers.sharded_embedding`` — device hot caches of
  ``capacity`` rows over a host-RAM tier (``embedding/``), ids spanning a
  2^40 space with no dense table anywhere;
* click-log records (variable-length id lists per slot) become fixed
  (ids, weights) batches through the ``sparse_batch`` transform
  (``dataio/sparse.py``) on the DataLoader's ordered worker pool
  (``make_loader``, as the JAX example feeds its program): the dense
  feeds arrive on the card, the raw ids stay on the host for the engine;
  ``make_batch`` stacks the same records by hand;
* Adam drives the dense half, each table its own row-sparse SGD.

    main, startup, feeds, (loss, pred) = build_programs()
    exe = Executor(); exe.run(startup, scope=scope)
    engine = EmbeddingEngine(scope=scope)
    for feed in make_loader(main, feeds, lambda: click_log(n), batch):
        feed = engine.prepare_feed(main, dict(feed))
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
"""

import numpy as np

from paddle_tpu_torch.dataio.sparse import make_sparse_batch_transform
from paddle_tpu_torch.embedding.table import splitmix64

__all__ = ["NUM_SLOTS", "IDS_PER_SLOT", "DEEP_DIM", "ID_SPACE", "CAPACITY",
           "EP", "build_programs", "click_log", "make_batch", "make_loader"]

NUM_SLOTS = 4
IDS_PER_SLOT = 5
DEEP_DIM = 16
ID_SPACE = 2 ** 40
CAPACITY = 4096
EP = 2


def build_programs(main_prog=None, startup_prog=None, capacity=CAPACITY,
                   min_bucket=8):
    """Wide (linear, zero-init) + deep (embedding -> MLP) -> sigmoid CTR,
    all sparse features on sharded_embedding tables of ``capacity`` rows.
    Returns (main, startup, feed_names, [loss, pred])."""
    import paddle_tpu_torch as fluid

    main_prog = main_prog if main_prog is not None else fluid.Program()
    startup_prog = (startup_prog if startup_prog is not None
                    else fluid.Program())
    with fluid.program_guard(main_prog, startup_prog):
        feeds = []
        wide_parts, deep_parts = [], []
        for i in range(NUM_SLOTS):
            ids = fluid.data(f"slot_{i}", shape=[-1, IDS_PER_SLOT],
                             dtype="int64")
            w = fluid.data(f"slot_{i}_w", shape=[-1, IDS_PER_SLOT],
                           dtype="float32")
            feeds += [ids.name, w.name]
            wide_e = fluid.layers.sharded_embedding(
                ids, 1, capacity=capacity, ep=EP, name=f"wide_{i}",
                init_range=0.0, lr=0.1, seed=100 + i, min_bucket=min_bucket,
            )
            deep_e = fluid.layers.sharded_embedding(
                ids, DEEP_DIM, capacity=capacity, ep=EP, name=f"deep_{i}",
                init_range=0.01, lr=0.1, seed=200 + i, min_bucket=min_bucket,
            )
            # weighted sum-pool over the slot (padding weight 0 -> its
            # repeated-id rows contribute exactly nothing)
            wexp = fluid.layers.reshape(w, [-1, IDS_PER_SLOT, 1])
            wide_parts.append(fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(wide_e, wexp), dim=1))
            deep_parts.append(fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(deep_e, wexp), dim=1))
        label = fluid.data("click", shape=[-1, 1], dtype="float32")
        feeds.append("click")

        wide = fluid.layers.sums(wide_parts)                  # [B, 1]
        deep = fluid.layers.concat(deep_parts, axis=1)
        for h in (64, 32):
            deep = fluid.layers.fc(deep, size=h, act="relu")
        logit = wide + fluid.layers.fc(deep, size=1)
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label)
        )
        pred = fluid.layers.sigmoid(logit)
        # Adam drives the DENSE half; every sharded table trains with its
        # own row-sparse SGD (the deferred rewrite strips Adam off the
        # slabs)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main_prog, startup_prog, feeds, [loss, pred]


def click_log(n, seed=0):
    """Synthetic click-log records: zipfian variable-length id lists per
    slot over a 2^40 space; click probability driven by a hash of slot
    0's first id so the model has signal to learn.

    The same stream as the JAX example's ``click_log``: the random draws
    come in the same order (per record, per slot a length and its zipf
    ranks, then the click's uniform), and the hashing runs once over all
    records afterwards."""
    rng = np.random.RandomState(seed)
    lengths, ranks, coins = [], [], np.empty(n)
    for r in range(n):
        for _i in range(NUM_SLOTS):
            k = rng.randint(1, IDS_PER_SLOT + 1)
            lengths.append(k)
            ranks.append(rng.zipf(1.5, size=k))
        coins[r] = rng.rand()
    lengths = np.asarray(lengths).reshape(n, NUM_SLOTS)
    flat = (np.concatenate(ranks).astype(np.uint64) if ranks
            else np.zeros(0, np.uint64))
    slot_of = np.repeat(np.tile(np.arange(NUM_SLOTS, dtype=np.uint64), n),
                        lengths.reshape(-1))
    ids = (splitmix64(flat + slot_of * np.uint64(1000))
           % np.uint64(ID_SPACE)).astype(np.int64).tolist()
    pos = 0
    for r in range(n):
        rec_slots = {}
        for i in range(NUM_SLOTS):
            k = int(lengths[r, i])
            rec_slots[f"slot_{i}"] = ids[pos:pos + k]
            pos += k
        p = (rec_slots["slot_0"][0] % 97 / 97.0) * 0.8 + 0.1
        yield {"slots": rec_slots, "click": float(coins[r] < p)}


def make_batch(records, feed_names):
    """One feed dict from click-log records: each record through the
    ``sparse_batch`` transform, then each field stacked over the batch."""
    transform = make_sparse_batch_transform(
        [f"slot_{i}" for i in range(NUM_SLOTS)], IDS_PER_SLOT)
    rows = [transform(r) for r in records]
    return {name: np.stack([row[i] for row in rows])
            for i, name in enumerate(feed_names)}


def make_loader(main, feed_names, records, batch, capacity=8, num_workers=2,
                places=None):
    """The JAX example's input pipeline: ``records`` (a zero-arg callable
    returning click-log records) through
    ``DataLoader.from_generator(feed_list, capacity, num_workers)
    .set_sample_generator(records, batch, sample_transform=...)``. The
    feed list is ``main``'s variables, so the loader keeps the raw ids,
    which ``EmbeddingEngine.prepare_feed`` reads, on the host and stages
    the rest on ``places`` (the first card when None)."""
    from paddle_tpu_torch.reader import DataLoader

    block = main.global_block()
    transform = make_sparse_batch_transform(
        [f"slot_{i}" for i in range(NUM_SLOTS)], IDS_PER_SLOT)
    return DataLoader.from_generator(
        feed_list=[block.var(n) for n in feed_names], capacity=capacity,
        num_workers=num_workers,
    ).set_sample_generator(records, batch, places=places,
                           sample_transform=transform)
