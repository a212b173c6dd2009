"""DeviceWorker: the per-batch execution strategy for dataset-mode training.

reference: python/paddle/fluid/device_worker.py:95 (DownpourSGD emitting a
protobuf for the C++ DownpourWorker, framework/device_worker.h:203) — the
worker pulls the batch's sparse rows, runs fwd/bwd, pushes sparse/dense
grads. The port's copy of the JAX package's ``device_worker.py``: a
"device worker" is the host-side driver around one executor step:

* Hogwild       — the plain step (dense training).
* DownpourSGD   — the PS loop: host-pull tables (layers.sparse_embedding)
                  route through the fleet PSWorker's pull -> step -> push;
                  remote tables (layers.distributed_embedding) pull and
                  push inside the step, in their ops' lowerings, and
                  prefetch one batch ahead.
* Section       — the plain step, as in the JAX package (whose
                  microbatched pipeline step is ROADMAP M11 here).

TrainerFactory mirrors the reference's trainer_factory.py: it reads
`program._fleet_opt` (set by the distributed optimizer) and assembles the
TrainerDesc + DeviceWorker that Executor.train_from_dataset consumes.
"""

from paddle_tpu_torch.trainer_desc import DistMultiTrainer, MultiTrainer
from paddle_tpu_torch.utils.enforce import enforce

__all__ = [
    "DeviceWorker",
    "Hogwild",
    "DownpourSGD",
    "Section",
    "DeviceWorkerFactory",
    "TrainerFactory",
]


class DeviceWorker:
    def __init__(self):
        self._infer = False
        self._program = None

    def _set_infer(self, infer):
        self._infer = infer

    def _set_program(self, program):
        self._program = program

    def prepare(self, exe, program, scope):
        """Called once before the batch loop."""

    def run_batch(self, exe, program, feed, fetch_list, scope):
        raise NotImplementedError

    def finish(self):
        """Called once after the batch loop (flush pending pushes)."""


class Hogwild(DeviceWorker):
    """reference: device_worker.py:72 — plain per-batch step."""

    def run_batch(self, exe, program, feed, fetch_list, scope):
        return exe.run(program, feed=feed, fetch_list=fetch_list, scope=scope)


class DownpourSGD(DeviceWorker):
    """reference: device_worker.py:95. Host-pull sparse tables go through
    the fleet's PSWorker; remote tables pull and push in the step's own
    lowerings (ops/misc_extra.py distributed_lookup_table)."""

    def __init__(self):
        super().__init__()
        self._ps_worker = None

    def prepare(self, exe, program, scope):
        tables = getattr(program, "_sparse_tables", None)
        if not tables:
            return  # remote-only (or dense) program: the step is self-contained
        from paddle_tpu_torch.fleet import parameter_server as psfleet

        worker = psfleet.fleet._worker_obj
        if worker is None and psfleet.fleet._client is not None:
            worker = psfleet.fleet.worker(exe, program)
        enforce(
            worker is not None,
            "DownpourSGD needs an initialized PS worker for host-pull "
            "sparse tables: call fleet.init_worker() (and optionally "
            "fleet.worker(exe)) before train_from_dataset",
        )
        self._ps_worker = worker

    def run_batch(self, exe, program, feed, fetch_list, scope):
        if self._ps_worker is not None:
            return self._ps_worker.run(
                program, feed, fetch_list=fetch_list, scope=scope,
                infer=self._infer,
            )
        return exe.run(program, feed=feed, fetch_list=fetch_list, scope=scope)

    def finish(self):
        if self._ps_worker is not None and not self._infer:
            self._ps_worker.flush()


class Section(DeviceWorker):
    """reference: device_worker.py:301 (pipeline section worker);
    per-batch driving is the plain step."""

    def run_batch(self, exe, program, feed, fetch_list, scope):
        return exe.run(program, feed=feed, fetch_list=fetch_list, scope=scope)


class DeviceWorkerFactory:
    def _create_device_worker(self, worker_type):
        classes = {c.__name__: c for c in (Hogwild, DownpourSGD, Section)}
        enforce(
            worker_type in classes,
            f"unknown device worker {worker_type!r} "
            f"(have {sorted(classes)})",
        )
        return classes[worker_type]()


class TrainerFactory:
    """reference: python/paddle/fluid/trainer_factory.py — assemble the
    trainer desc from the program's fleet opt info."""

    def _create_trainer(self, opt_info=None):
        opt_info = opt_info or {}
        trainer_name = opt_info.get("trainer", "MultiTrainer")
        worker_name = opt_info.get("device_worker", "Hogwild")
        trainers = {
            "MultiTrainer": MultiTrainer,
            "DistMultiTrainer": DistMultiTrainer,
        }
        enforce(
            trainer_name in trainers,
            f"unknown trainer {trainer_name!r} (have {sorted(trainers)})",
        )
        trainer = trainers[trainer_name]()
        trainer._set_device_worker(
            DeviceWorkerFactory()._create_device_worker(worker_name)
        )
        if "fleet_desc" in opt_info:
            trainer._set_fleet_desc(opt_info["fleet_desc"])
        return trainer
