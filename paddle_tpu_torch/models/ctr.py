"""Wide&Deep CTR model, copied from the JAX package's ``models/ctr.py``:
hashed sparse id slots -> wide (linear, dim 1) + deep (embedding + MLP)
-> sigmoid CTR. Three table modes:

* ``ps_mode=True``: ``layers.sparse_embedding`` tables on the parameter
  server; the PS worker pulls the batch's unique rows on the host
  (``fleet.parameter_server.PSWorker``), ids span the full u64 space;
* ``ps_mode="remote"``: ``layers.distributed_embedding`` tables, pulled
  and pushed by the lookup and push ops' lowerings (ids < 2^31);
* ``ps_mode=False``: dense ``[vocab_size, dim]`` tables on the card.
  With an SGD optimizer the deferred ``sparse_weight_update`` pass turns
  each table's grad + sgd into one row-sparse ``sgd_sparse`` update
  (``FLAGS_pallas_sparse_update`` sends it through the sparse-row
  kernel).
"""

import numpy as np

import paddle_tpu_torch as fluid

__all__ = ["build_ctr_train", "synthetic_batch", "sgd_sparse_program"]


def build_ctr_train(
    num_slots=8,
    ids_per_slot=3,
    deep_dim=16,
    hidden=(64, 32),
    sparse_lr=0.1,
    optimizer=None,
    ps_mode=True,
    vocab_size=None,
):
    """Returns (main, startup, feeds, fetches). ps_mode=True uses
    PS sparse_embedding (host pre-pull, ids unbounded); ps_mode="remote"
    uses distributed_embedding (pull/push in the ops' lowerings, the
    reference's parameter_prefetch flow); ps_mode=False uses an on-device
    dense table of `vocab_size` rows (parity baseline for tests)."""
    remote = ps_mode == "remote"
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        slots = [
            fluid.data(f"slot_{i}", shape=[-1, ids_per_slot], dtype="int64")
            for i in range(num_slots)
        ]
        label = fluid.data("click", shape=[-1, 1], dtype="float32")

        wide_parts, deep_parts = [], []
        for i, s in enumerate(slots):
            if remote:
                wide_e = fluid.layers.distributed_embedding(
                    s, [0, 1], table_name=f"wide_{i}", init_range=0.0
                )
                deep_e = fluid.layers.distributed_embedding(
                    s, [0, deep_dim], table_name=f"deep_{i}", init_range=0.0
                )
            elif ps_mode:
                wide_e = fluid.layers.sparse_embedding(
                    s, 1, name=f"wide_{i}", init_range=0.0
                )
                deep_e = fluid.layers.sparse_embedding(
                    s, deep_dim, name=f"deep_{i}", init_range=0.01
                )
            else:
                wide_e = fluid.layers.embedding(
                    s, (vocab_size, 1),
                    param_attr=fluid.ParamAttr(
                        name=f"wide_{i}_w",
                        initializer=fluid.initializer.Constant(0.0),
                    ),
                )
                deep_e = fluid.layers.embedding(
                    s, (vocab_size, deep_dim),
                    param_attr=fluid.ParamAttr(name=f"deep_{i}_w"),
                )
            # sum-pool the slot's ids: [B, ids_per_slot, d] -> [B, d]
            wide_parts.append(fluid.layers.reduce_sum(wide_e, dim=1))
            deep_parts.append(fluid.layers.reduce_sum(deep_e, dim=1))

        wide = fluid.layers.sums(wide_parts)  # [B, 1]
        deep = fluid.layers.concat(deep_parts, axis=1)
        for h in hidden:
            deep = fluid.layers.fc(deep, size=h, act="relu")
        deep_logit = fluid.layers.fc(deep, size=1)
        logit = wide + deep_logit
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label)
        )
        pred = fluid.layers.sigmoid(logit)
        opt = optimizer or fluid.optimizer.Adam(learning_rate=1e-3)
        if ps_mode:
            from paddle_tpu_torch.fleet import parameter_server as psfleet

            strategy = psfleet.PSDistributedStrategy(
                mode="sync", sparse_lr=sparse_lr
            )
            psfleet.fleet.distributed_optimizer(opt, strategy).minimize(loss)
        else:
            opt.minimize(loss)
    return main, startup, slots + [label], [loss, pred]


def synthetic_batch(rng, batch, num_slots=8, ids_per_slot=3, id_space=2**40):
    """Clicky synthetic CTR data: click probability driven by a hash of the
    first slot's ids, so the model has signal to learn."""
    feed = {}
    base = rng.randint(0, id_space, size=(batch, ids_per_slot), dtype=np.int64)
    for i in range(num_slots):
        ids = rng.randint(0, id_space, size=(batch, ids_per_slot), dtype=np.int64)
        if i == 0:
            ids = base
        feed[f"slot_{i}"] = ids
    p = ((base.sum(axis=1) % 97) / 97.0) * 0.8 + 0.1
    feed["click"] = (rng.rand(batch) < p).astype("float32").reshape(batch, 1)
    return feed


def sgd_sparse_program(vocab, dim, n):
    """A program of one ``sgd_sparse`` (the row update that each table of
    ``build_ctr_train`` gets from the deferred rewrite), to drive that op
    alone: it updates a persistable ``table`` [vocab, dim] in place, fed
    ``ids`` (int64 [n]), ``rows`` [n, dim] and ``lr`` [1]."""
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        fluid.data("ids", [n], dtype="int64")
        fluid.data("rows", [n, dim])
        fluid.data("lr", [1])
    block = main.global_block()
    block.create_var(name="table", shape=[vocab, dim], dtype="float32",
                     persistable=True)
    block.append_op("sgd_sparse",
                    inputs={"Param": ["table"], "Ids": ["ids"],
                            "RowGrad": ["rows"], "LearningRate": ["lr"]},
                    outputs={"ParamOut": ["table"]},
                    attrs={"padding_idx": -1})
    return main
