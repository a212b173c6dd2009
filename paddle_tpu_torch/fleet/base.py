"""Fleet base: the unified distributed-training facade, the counterpart
of the JAX package's ``fleet/base.py``.

Reference: python/paddle/fluid/incubate/fleet/base/fleet_base.py —
`Fleet` :38 (init :184 with a RoleMaker, distributed_optimizer :238) and
`DistributedOptimizer` :256. User code stays single-program; every
process is one rank of a ``torch.distributed`` process group, and
``init`` joins that group (``parallel.env.make_mesh``) where the JAX
package brings up ``jax.distributed``.
"""

import abc

from paddle_tpu_torch.fleet.role_maker import (
    PaddleCloudRoleMaker, RoleMakerBase)
from paddle_tpu_torch.parallel.env import ParallelEnv, make_mesh

__all__ = ["Fleet", "DistributedOptimizer"]


class Fleet(metaclass=abc.ABCMeta):
    def __init__(self):
        self._role_maker = None
        self._optimizer = None
        self._is_initialized = False
        self._origin_program = None
        self._main_program = None    # post-minimize (compiled) program
        self._startup_program = None

    # ---- role delegation ------------------------------------------------
    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def server_index(self):
        return self._role_maker.server_index()

    def server_num(self):
        return self._role_maker.server_num()

    def is_server(self):
        return self._role_maker.is_server()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    # ---- lifecycle ------------------------------------------------------
    def init(self, role_maker=None):
        """Reference: fleet_base.py:184. A worker of a job of more than one
        process (``PADDLE_TRAINERS_NUM`` > 1, as the launcher sets it)
        also joins the process group, through the launcher's
        rendezvous."""
        if role_maker is None:
            role_maker = PaddleCloudRoleMaker()
        if not isinstance(role_maker, RoleMakerBase):
            raise TypeError("role_maker must be a RoleMakerBase")
        self._role_maker = role_maker
        role_maker.generate_role()
        if role_maker.is_worker() and ParallelEnv().world_size > 1:
            make_mesh()
        self._is_initialized = True

    @property
    def main_program(self):
        return self._main_program

    @property
    def startup_program(self):
        return self._startup_program

    # ---- to be provided by the mode (collective / parameter server) -----
    @abc.abstractmethod
    def distributed_optimizer(self, optimizer, strategy=None):
        ...

    @abc.abstractmethod
    def init_worker(self):
        ...

    @abc.abstractmethod
    def init_server(self, model_dir=None):
        ...

    @abc.abstractmethod
    def run_server(self):
        ...

    @abc.abstractmethod
    def stop_worker(self):
        ...

    def save_inference_model(
        self,
        executor,
        dirname,
        feeded_var_names,
        target_vars,
        main_program=None,
        export_for_deployment=True,
    ):
        """Written by the first worker only: the ranks hold one value of
        every parameter (the others return None)."""
        from paddle_tpu_torch import io

        if not self.is_first_worker():
            return None
        prog = main_program or self._origin_program
        return io.save_inference_model(
            dirname, feeded_var_names, target_vars, executor, main_program=prog
        )

    def save_persistables(self, executor, dirname, main_program=None):
        """Written by the first worker only, as ``save_inference_model``."""
        from paddle_tpu_torch import io

        if not self.is_first_worker():
            return None
        prog = main_program or self._origin_program
        return io.save_persistables(executor, dirname, main_program=prog)


class DistributedOptimizer(metaclass=abc.ABCMeta):
    """Wraps a regular Optimizer; minimize() additionally rewrites/compiles
    the program for the distributed mode (reference: fleet_base.py:256)."""

    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy

    @abc.abstractmethod
    def minimize(
        self, loss, startup_program=None, parameter_list=None, no_grad_set=None
    ):
        ...

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set
        )

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)
