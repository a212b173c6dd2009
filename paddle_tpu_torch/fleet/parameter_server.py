"""Parameter-server fleet mode: billion-feature sparse training.

Reference: python/paddle/fluid/incubate/fleet/parameter_server/ — the pslib
flow (DownpourWorker, device_worker.h:203): per batch, workers pull the
batch's sparse rows from servers, run fwd/bwd locally, and push sparse grads
back; dense parameters stay worker-side. The port's copy of the JAX
package's ``fleet/parameter_server.py``: dense params live on the card,
sparse tables live on native PS servers (``distributed/ps.py``, the
port's copy of the JAX package's server), and the worker's pull -> step
-> push pipeline is host code around the executor step (PSWorker.run).
sparse_embedding programs need no transpilation (the rows/idx feed
structure is emitted at build time); reference-style
`embedding(is_distributed=True)` programs ARE transpiled by
ParameterServerOptimizer.minimize into remote lookups — the
DistributeTranspiler rewrite, pulling and pushing in their ops'
lowerings.

Usage:
    from paddle_tpu_torch.fleet import parameter_server as psfleet
    fleet = psfleet.fleet
    fleet.init(role_maker)
    if fleet.is_server():
        fleet.init_server(); fleet.run_server()
    else:
        opt = fleet.distributed_optimizer(optimizer, strategy)
        opt.minimize(loss)
        fleet.init_worker()
        worker = fleet.worker(exe)
        for batch: worker.run(program, feed, fetch_list)
        fleet.stop_worker()
"""

import os
import time

import numpy as np

import torch

from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.core.ir import default_main_program, default_startup_program
from paddle_tpu_torch.fleet.base import DistributedOptimizer, Fleet
from paddle_tpu_torch.io import to_host
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["fleet", "PSDistributedStrategy", "ParameterServerOptimizer", "PSWorker"]

_OPT_CODES = {"sgd": 0, "adagrad": 1}


class PSDistributedStrategy:
    """reference: incubate/fleet/parameter_server/distribute_transpiler/
    distributed_strategy.py (Sync/Async/Geo).

    mode="geo" is GEO-SGD delta-sync (reference: python/paddle/fluid/
    transpiler/geo_sgd_transpiler.py): dense parameters train LOCALLY with
    the full optimizer; every `merge_steps` steps the worker pushes
    (param - param_at_last_sync) / worker_num into the server's global
    copy and pulls the merged result. Sparse tables stay server-side."""

    def __init__(self, mode="sync", sparse_lr=0.1, merge_steps=4):
        enforce(mode in ("sync", "async", "half_async", "geo"), f"bad mode {mode}")
        self.mode = mode
        self.sparse_lr = sparse_lr
        self.merge_steps = merge_steps


class ParameterServerOptimizer(DistributedOptimizer):
    """minimize() = normal dense minimize + grad seeds for every sparse
    table's pulled-rows var (so rows@GRAD exists for the worker to fetch)."""

    def __init__(self, optimizer, strategy=None):
        super().__init__(optimizer, strategy or PSDistributedStrategy())

    def _transpile_distributed_embeddings(self, program, startup_program):
        """The reference's DistributeTranspiler rewrite for
        `embedding(..., is_distributed=True)` (reference: python/paddle/
        fluid/transpiler/distribute_transpiler.py lookup-table handling):
        each lookup over an is_distributed Parameter becomes the remote
        in-graph form — the table never materializes locally. The local
        Parameter and its startup init are removed; the table is created
        server-side at fleet.init_worker."""
        import warnings as _warnings

        block = program.global_block()
        tables = getattr(program, "_remote_tables", None)
        # the rewrite covers the GLOBAL block; an is_distributed lookup
        # buried in a cond/while sub-block must fail loudly, not silently
        # train a worker-local table
        for b in program.blocks[1:]:
            for op in b.ops:
                if op.type not in ("lookup_table", "lookup_table_v2"):
                    continue
                wname = op.inputs.get("W", [None])[0]
                w = block._find_var_recursive(wname) if wname else None
                enforce(
                    w is None or not getattr(w, "is_distributed", False),
                    f"embedding '{wname}': is_distributed=True inside a "
                    "cond/while sub-block cannot transpile to the remote "
                    "path — hoist the lookup out of the control-flow "
                    "region or keep the table local",
                )
        # group by table var first: one W may feed several lookups (shared
        # table across slots) — all of them rewrite against ONE server
        # table, and the var is dropped once
        sites = {}  # wname -> [op index]
        for i, op in enumerate(block.ops):
            if op.type not in ("lookup_table", "lookup_table_v2"):
                continue
            wname = op.inputs.get("W", [None])[0]
            w = block.vars.get(wname)
            if w is None or not getattr(w, "is_distributed", False):
                continue
            # validate BEFORE any mutation: a mid-rewrite failure would
            # leave a half-transpiled program (some lookups remote, the
            # local table still present, no push ops)
            pad = op.attrs.get("padding_idx", -1)
            enforce(
                pad is None or pad < 0,
                f"embedding '{wname}': is_distributed=True with "
                "padding_idx is not supported on the remote path — drop "
                "padding_idx (mask downstream) or keep the table local",
            )
            sites.setdefault(wname, []).append(i)
        # resolve-startup check belongs with the other pre-mutation
        # validations: raising mid-rewrite would leave a half-transpiled
        # program (remote lookups in place, init ops never stripped)
        enforce(
            not sites or startup_program is not None,
            f"embedding(is_distributed=True) tables {sorted(sites)}: "
            "cannot resolve the startup program to strip their init ops — "
            "minimize() ran outside the program's own program_guard and "
            "got no startup_program. Pass minimize(loss, "
            "startup_program=...) (the reference transpiler takes it "
            "explicitly); otherwise running the real startup would still "
            "materialize the full [vocab, dim] local table.",
        )
        rewritten = []
        from paddle_tpu_torch.core.ir import Operator
        from paddle_tpu_torch.layers.nn import _next_table_id

        for wname, idxs in sites.items():
            w = block.vars[wname]
            dim = int(w.shape[-1])
            if tables is None:
                tables = program._remote_tables = {}
            table_id = _next_table_id(program)
            for k, i in enumerate(idxs):
                op = block.ops[i]
                block.ops[i] = Operator(
                    block, "distributed_lookup_table",
                    {"Ids": list(op.inputs["Ids"])},
                    {"Outputs": list(op.outputs["Out"])},
                    {"table_name": wname, "dim": dim},
                )
                out_name = op.outputs["Out"][0]
                ov = block.vars.get(out_name)
                if ov is not None:
                    ov.stop_gradient = False
                entry_key = wname if k == 0 else f"{wname}__use{k}"
                tables[entry_key] = {
                    "table_id": table_id,
                    "table_name": wname,  # the wire/registration name
                    "ids": op.inputs["Ids"][0],
                    "out": out_name,
                    "dim": dim,
                    "init_range": 0.01,
                    "optimizer": "sgd",
                }
            rewritten.append(wname)
            # the table exists only on the servers: drop the local
            # Parameter and its startup initialization
            block.vars.pop(wname, None)
            sblock = startup_program.global_block()
            kept_init = [
                o for o in sblock.ops if wname not in o.output_names()
            ]
            if len(kept_init) == len(sblock.ops):
                _warnings.warn(
                    f"embedding(is_distributed=True) table '{wname}': no "
                    "init ops found in the resolved startup program — if "
                    "another startup program initializes it, the full "
                    "[vocab, dim] local table will still materialize "
                    "there (pass that program via minimize(loss, "
                    "startup_program=...))",
                    stacklevel=4,
                )
            sblock.ops = kept_init
            sblock.vars.pop(wname, None)
        if rewritten:
            program._bump_version()
            _warnings.warn(
                f"embedding(is_distributed=True) tables {rewritten} "
                "transpiled to parameter-server remote lookups (the "
                "reference's distribute_transpiler rewrite); they train "
                "with the server-side optimizer at strategy.sparse_lr",
                stacklevel=3,
            )
        return rewritten

    @staticmethod
    def _resolve_startup(program):
        """The guard-paired startup when it is provably the right one
        (program IS the default main, so the default pair is this
        model's), else None — never a guess."""
        if program is default_main_program():
            return default_startup_program()
        return None

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        # default_startup_program() is only the real
        # startup when `program` is itself the default main (i.e. minimize
        # runs inside the user's program_guard, where the guard binds the
        # pair). Outside the guard the default pair belongs to some OTHER
        # model; stripping a table's init ops from it is a no-op on the
        # real startup, which would then still materialize the full
        # [vocab, dim] local table. Resolve honestly: explicit argument >
        # guard-paired default > None (transpile then demands the table's
        # startup explicitly).
        startup_program = startup_program or self._resolve_startup(program)
        self._transpile_distributed_embeddings(program, startup_program)
        tables = getattr(program, "_sparse_tables", {})
        remote = getattr(program, "_remote_tables", {})
        rows_names = [t["rows"] for t in tables.values()]
        # remote tables: seed their lookup OUTPUT so Out@GRAD gets
        # finalized even though the lookup op has no differentiable inputs
        out_names = [t["out"] for t in remote.values()]
        opt = self._optimizer
        opt.helper = LayerHelper(opt.__class__.__name__)
        opt._create_global_learning_rate()
        params_grads = append_backward(
            loss, parameter_list, no_grad_set,
            extra_seeds=rows_names + out_names,
        )
        block = loss.block
        for tname, t in remote.items():
            # in-step push of the merged row grads (op_role=backward, as in
            # the JAX package)
            block.append_op(
                "distributed_push_sparse",
                {"Ids": [t["ids"]], "Grad": [t["out"] + "@GRAD"]},
                {},
                {"table_name": t.get("table_name", tname), "dim": t["dim"],
                 "op_role": 1},
            )
        optimize_ops = opt.apply_gradients(params_grads)
        # dataset-mode wiring (reference: the transpiler writing opt_info
        # into the program for trainer_factory): train_from_dataset reads
        # this to drive batches through the Downpour device worker
        program._fleet_opt = {
            "trainer": "DistMultiTrainer",
            "device_worker": "DownpourSGD",
        }
        fleet._origin_program = program
        fleet._main_program = program
        fleet._startup_program = startup_program or default_startup_program()
        fleet._strategy = self._strategy
        return optimize_ops, params_grads


class PSWorker:
    """Per-process worker driver: pull -> compiled step -> push.

    The reference runs this loop thread-per-core in C++ DeviceWorkers
    (reference: paddle/fluid/framework/device_worker.h:203 DownpourWorker,
    hogwild_worker.cc:237); here one loop feeds the whole card — overlap
    comes from the async Communicator and the prefetch thread.

    Host transfers a step: the pulled rows and their index go up as feeds,
    and each table's row grad comes back as a fetch (``stats`` counts the
    pulls, pushes and their seconds)."""

    GEO_DENSE_TABLE = 1 << 30  # reserved dense table id for geo delta-sync

    def __init__(self, exe, client, tables, strategy, program=None,
                 worker_num=1, is_first_worker=True):
        from paddle_tpu_torch.distributed.ps import Communicator

        self._exe = exe
        self._client = client
        self._tables = tables
        self._strategy = strategy
        mode = "sync" if strategy.mode == "sync" else "async"
        self._comm = Communicator(
            client, mode=mode, merge_steps=strategy.merge_steps
        )
        self._geo = strategy.mode == "geo"
        self._geo_params = []
        self._geo_snapshot = None
        self._geo_step = 0
        self._worker_num = max(int(worker_num), 1)
        self.stats = {"steps": 0, "pulls": 0, "pushes": 0,
                      "pull_seconds": 0.0, "push_seconds": 0.0}
        if self._geo and program is not None:
            self._geo_params = [p.name for p in program.all_parameters()]
            if self._geo_params:
                total = self._geo_total_size(program)
                if is_first_worker:
                    # create (zero) + seed the global copy with this
                    # worker's init params; creating on every worker would
                    # wipe the seed (create replaces the table)
                    client.create_table(
                        self.GEO_DENSE_TABLE, dense_size=total,
                        is_dense=True, optimizer=0,
                    )
                    vec = self._concat_params()
                    client.push_dense(self.GEO_DENSE_TABLE, -vec, 1.0)
                if self._worker_num > 1:
                    client.barrier(self._worker_num)
                if is_first_worker:
                    self._geo_snapshot = self._concat_params()
                else:
                    # startup broadcast: every worker starts from worker 0's
                    # init (reference: geo_sgd startup param sync)
                    merged = client.pull_dense(self.GEO_DENSE_TABLE)
                    self._scatter_params(merged)
                    self._geo_snapshot = merged

    def _geo_total_size(self, program):
        return sum(
            int(np.prod(p.shape)) for p in program.all_parameters()
        )

    def _concat_params(self, scope=None):
        from paddle_tpu_torch.core.scope import global_scope

        scope = scope or global_scope()
        return np.concatenate([
            to_host(scope.find_var(n)).astype(np.float32).reshape(-1)
            for n in self._geo_params
        ])

    def _scatter_params(self, vec, scope=None):
        from paddle_tpu_torch.core.scope import global_scope

        scope = scope or global_scope()
        off = 0
        for n in self._geo_params:
            cur = scope.find_var(n)
            size = int(np.prod(cur.shape))
            new = vec[off:off + size].reshape(tuple(cur.shape))
            if isinstance(cur, torch.Tensor):
                # a copy: the merged vector is also the next snapshot,
                # and the step may update a parameter in place
                new = torch.tensor(new, device=cur.device, dtype=cur.dtype)
            else:
                new = new.astype(np.asarray(cur).dtype)
            scope.set(n, new)
            off += size

    def _geo_sync(self, scope=None):
        """Delta push + fresh pull (reference: geo_sgd_transpiler.py — there
        send_vars of deltas to the pserver's sum table)."""
        cur = self._concat_params(scope)
        delta = (cur - self._geo_snapshot) / self._worker_num
        # server runs param -= lr * grad; lr = -1 turns the push into +=
        self._client.push_dense(self.GEO_DENSE_TABLE, delta, -1.0)
        merged = self._client.pull_dense(self.GEO_DENSE_TABLE)
        self._scatter_params(merged, scope)
        self._geo_snapshot = merged

    def prefetch(self, program, next_feed):
        """Announce the NEXT batch's ids so the remote lookups
        (distributed_embedding) overlap their server pull with the current
        step's compute — the reference's prefetch thread
        (reference: distributed/parameter_prefetch.cc:1)."""
        from paddle_tpu_torch.distributed import lookup as _rl

        _rl.prefetch_for_program(program, next_feed)

    def run(self, program, feed, fetch_list=None, scope=None, infer=False):
        """One batch: pull sparse rows, run the step, push row grads.
        `infer=True` (infer_from_dataset) pulls but neither fetches grads
        nor pushes — evaluation must not move the server tables."""
        from paddle_tpu_torch.distributed.lookup import _host_array

        fetch_list = list(fetch_list or [])
        feed = dict(feed)
        pulled = {}  # table name -> (uniq_ids,)
        t0 = time.perf_counter()
        for tname, t in self._tables.items():
            ids = _host_array(feed[t["ids"]])
            uniq, inv = np.unique(ids.astype(np.uint64), return_inverse=True)
            rows = self._client.pull_sparse(t["table_id"], uniq, t["dim"])
            feed[t["rows"]] = rows
            feed[t["idx"]] = inv.astype(np.int32).reshape(ids.shape)
            pulled[tname] = uniq
            self.stats["pulls"] += 1
        self.stats["pull_seconds"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        if infer:
            return self._exe.run(
                program, feed=feed, fetch_list=fetch_list, scope=scope
            )
        grad_fetches = [t["rows"] + "@GRAD" for t in self._tables.values()]
        out = self._exe.run(
            program, feed=feed, fetch_list=fetch_list + grad_fetches,
            scope=scope,
        )
        n_user = len(fetch_list)
        t0 = time.perf_counter()
        for (tname, t), g in zip(self._tables.items(), out[n_user:]):
            self._comm.push_sparse(
                t["table_id"], pulled[tname], np.asarray(g),
                self._strategy.sparse_lr,
            )
            self.stats["pushes"] += 1
        self.stats["push_seconds"] += time.perf_counter() - t0
        if self._geo and self._geo_params:
            self._geo_step += 1
            if self._geo_step % self._strategy.merge_steps == 0:
                self._geo_sync(scope)
                self._geo_pending = 0
            else:
                self._geo_pending = getattr(self, "_geo_pending", 0) + 1
        return out[:n_user]

    def flush(self):
        self._comm.flush()
        # geo: ship the tail of the last partial merge window — without
        # this, local progress since the last merge_steps boundary never
        # reaches the server's global copy
        if self._geo and getattr(self, "_geo_pending", 0):
            self._geo_sync()
            self._geo_pending = 0

    def stop(self):
        self._comm.stop()


class _PSFleet(Fleet):
    def __init__(self):
        super().__init__()
        self._server = None
        self._client = None
        self._worker_obj = None
        self._strategy = None

    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = ParameterServerOptimizer(optimizer, strategy)
        return self._optimizer

    # -- server side -------------------------------------------------------
    def init_server(self, model_dir=None, port=None):
        from paddle_tpu_torch.distributed.ps import PSServer

        if port is None:
            eps = self.server_endpoints()
            me = self.server_index()
            port = int(eps[me].rsplit(":", 1)[1]) if eps and me >= 0 else 0
        self._server = PSServer(port)
        return self._server

    def run_server(self):
        enforce(self._server is not None, "init_server first")
        while True:
            time.sleep(1)

    # -- worker side -------------------------------------------------------
    def init_worker(self, program=None):
        from paddle_tpu_torch.distributed.ps import PSClient

        program = program or self._origin_program
        eps = self.server_endpoints()
        if not eps and self._server is not None:
            eps = [self._server.endpoint]  # single-process test mode
        enforce(eps, "no server endpoints (set PADDLE_PSERVERS_IP_PORT_LIST)")
        self._client = PSClient(eps)
        tables = getattr(program, "_sparse_tables", {})
        remote = getattr(program, "_remote_tables", {})
        if self.worker_index() <= 0:
            created = set()
            for t in list(tables.values()) + list(remote.values()):
                if t["table_id"] in created:
                    continue  # shared table: several lookups, one table
                created.add(t["table_id"])
                self._client.create_table(
                    t["table_id"],
                    dim=t["dim"],
                    init_range=t["init_range"],
                    optimizer=_OPT_CODES.get(t["optimizer"], 0),
                )
        if remote:
            from paddle_tpu_torch.distributed import lookup as _rl

            strategy = self._strategy or PSDistributedStrategy()
            ctx = _rl.RemoteLookupContext(
                self._client, sparse_lr=strategy.sparse_lr
            )
            for tname, t in remote.items():
                ctx.register(
                    t.get("table_name", tname), t["table_id"], t["dim"]
                )
            _rl.activate(ctx)
        if self.worker_num() > 1:
            self._client.barrier(self.worker_num())

    def worker(self, exe, program=None):
        program = program or self._origin_program
        tables = getattr(program, "_sparse_tables", {})
        self._worker_obj = PSWorker(
            exe, self._client, tables,
            self._strategy or PSDistributedStrategy(),
            program=program,
            worker_num=max(self.worker_num(), 1),
            is_first_worker=self.worker_index() <= 0,
        )
        return self._worker_obj

    def stop_worker(self):
        from paddle_tpu_torch.distributed import lookup as _rl

        if self._worker_obj is not None:
            self._worker_obj.stop()
        _rl.deactivate()
        if self._client is not None:
            self._client.close()
        # clear worker state: a later init_worker/worker cycle (next job or
        # test) must not resurrect this client's tables
        self._worker_obj = None
        self._client = None

    # -- persistence -------------------------------------------------------
    def save_sparse_tables(self, dirname):
        tables = getattr(self._origin_program, "_sparse_tables", {})
        os.makedirs(dirname, exist_ok=True)
        for tname, t in tables.items():
            self._client.save(t["table_id"], os.path.join(dirname, tname + ".tbl"))

    def load_sparse_tables(self, dirname):
        tables = getattr(self._origin_program, "_sparse_tables", {})
        for tname, t in tables.items():
            self._client.load(t["table_id"], os.path.join(dirname, tname + ".tbl"))


fleet = _PSFleet()
