"""TrainerDesc: dataset-mode training configuration.

reference: python/paddle/fluid/trainer_desc.py:21 — there the desc is a
protobuf handed to C++ MultiTrainer/DistMultiTrainer spawning one
DeviceWorker thread per core (framework/trainer.h:98). The port's copy of
the JAX package's ``trainer_desc.py``: one step runs at a time on the
card, so the thread pool collapses into the native datafeed producing
batches while the card runs; the desc survives as the configuration
object `Executor.train_from_dataset` consumes — which
device worker drives each batch (Hogwild = plain step, DownpourSGD = the
PS pull/step/push loop, Section = microbatched pipeline), what to fetch,
and the print cadence.
"""

__all__ = ["TrainerDesc", "MultiTrainer", "DistMultiTrainer"]


class TrainerDesc:
    def __init__(self):
        self._fetch_vars = []
        self._fetch_info = []
        self._print_period = 100
        self._debug = False
        self._thread_num = 1
        self._device_worker = None
        self._infer = False
        self._program = None
        self._fleet_desc = None

    def _set_fetch_var_and_info(self, fetch_vars, fetch_info, print_period):
        self._fetch_vars = list(fetch_vars or [])
        self._fetch_info = list(fetch_info or [])
        self._print_period = print_period

    def _set_debug(self, debug):
        self._debug = debug

    def _set_thread(self, thread_num):
        # accepted for parity: batch production threads live in the native
        # datafeed; the device runs one step at a time
        self._thread_num = thread_num

    def _set_device_worker(self, device_worker):
        self._device_worker = device_worker
        device_worker._set_infer(self._infer)

    def _set_infer(self, infer):
        self._infer = infer
        if self._device_worker is not None:
            self._device_worker._set_infer(infer)

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program
        if self._device_worker is not None:
            self._device_worker._set_program(program)


class MultiTrainer(TrainerDesc):
    """Single-process dataset trainer (reference: trainer_desc.py:215)."""


class DistMultiTrainer(TrainerDesc):
    """PS-fleet dataset trainer (reference: trainer_desc.py:236): the
    device worker runs the Downpour loop against the parameter servers."""
