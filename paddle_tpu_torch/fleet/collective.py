"""Collective fleet mode: data, pipeline and tensor parallelism over the
strategy's mesh, the counterpart of the JAX package's
``fleet/collective.py``.

Reference: python/paddle/fluid/incubate/fleet/collective/__init__.py —
`CollectiveOptimizer` :378 transpiles the program (inserting c_allreduce
ops, python/paddle/fluid/transpiler/collective.py:178) and compiles with
ParallelExecutor (:312-376). As in the JAX package, ``minimize`` runs the
plain optimizer pass and hands back a ``CompiledProgram`` over the mesh
the ``DistributedStrategy`` builds; its dense data-parallel path
(``parallel/data_parallel.py``) puts in the collectives GSPMD puts in
there, so no transpiler inserts collective ops.
"""

from paddle_tpu_torch.compiler import BuildStrategy, CompiledProgram
from paddle_tpu_torch.core.ir import default_startup_program
from paddle_tpu_torch.fleet.base import DistributedOptimizer, Fleet
from paddle_tpu_torch.parallel.env import make_mesh

__all__ = ["DistributedStrategy", "CollectiveOptimizer", "fleet"]

# placement options the port does not run yet: feed specs (sequence
# parallelism), the cost stage's axis tags, the pipeline runtime's schedules
_NOT_PORTED = ("input_specs", "mesh_axis_tags", "pipeline_schedule",
               "pipeline_interleave")


class DistributedStrategy(BuildStrategy):
    """Extends BuildStrategy the way the reference's collective
    DistributedStrategy does (reference: incubate/fleet/collective/
    __init__.py:134), with the JAX package's fields: ``mesh_shape`` and
    ``mesh_axis_names`` build the mesh, ``param_rules``, ``param_specs``
    and ``spec_layout`` place the parameters (``CompiledProgram.
    with_parallel``). ``recompute`` (or ``forward_recompute``) wraps the
    optimizer in ``RecomputeOptimizer`` at ``recompute_checkpoints``.
    ``input_specs``, ``mesh_axis_tags`` and the pipeline schedules raise
    naming ROADMAP M11. NCCL tuning knobs are accepted and change
    nothing."""

    def __init__(self):
        super().__init__()
        self.mesh_shape = None
        self.mesh_axis_names = None
        self.mesh_axis_tags = None
        self.param_rules = None
        self.pipeline_schedule = None
        self.pipeline_interleave = None
        self.param_specs = None
        self.input_specs = None
        self.spec_layout = None
        # feature toggles, applied as program rewrites in minimize()
        self.use_amp = False
        self.amp_lists = None
        self.init_loss_scaling = 2.0 ** 15
        self.use_dynamic_loss_scaling = True
        self.recompute = False
        self.recompute_checkpoints = None
        # accepted-for-parity NCCL knobs
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 1
        self.forward_recompute = False  # alias some configs use

    def build_mesh(self):
        return make_mesh(shape=self.mesh_shape,
                         axis_names=self.mesh_axis_names)


class CollectiveOptimizer(DistributedOptimizer):
    def __init__(self, optimizer, strategy=None):
        super().__init__(optimizer, strategy or DistributedStrategy())

    def minimize(
        self, loss, startup_program=None, parameter_list=None, no_grad_set=None
    ):
        """The optimizer pass (with recompute segments under
        ``recompute``, under AMP with ``use_amp``), then
        ``fleet.main_program``: a ``CompiledProgram`` over the strategy's
        mesh. What is not ported raises before the program changes."""
        strategy = self._strategy
        given = [f for f in _NOT_PORTED
                 if getattr(strategy, f) not in (None, False)]
        if given:
            raise NotImplementedError(
                f"DistributedStrategy placement ({', '.join(given)}) is not "
                "ported yet (ROADMAP M11)")
        mesh = strategy.build_mesh()
        opt = self._optimizer
        if strategy.recompute or strategy.forward_recompute:
            from paddle_tpu_torch.optimizer import RecomputeOptimizer

            opt = RecomputeOptimizer(opt)
            if strategy.recompute_checkpoints:
                opt._set_checkpoints(strategy.recompute_checkpoints)
        if strategy.use_amp:
            from paddle_tpu_torch import amp

            opt = amp.decorate(
                opt,
                amp_lists=strategy.amp_lists,
                init_loss_scaling=strategy.init_loss_scaling,
                use_dynamic_loss_scaling=strategy.use_dynamic_loss_scaling,
            )
        optimize_ops, params_grads = opt.minimize(
            loss, startup_program, parameter_list, no_grad_set
        )
        main = loss.block.program
        fleet._origin_program = main
        fleet._startup_program = startup_program or default_startup_program()
        fleet._main_program = CompiledProgram(
            main, build_strategy=strategy).with_parallel(
                mesh=mesh, loss_name=loss.name,
                param_rules=strategy.param_rules,
                param_specs=strategy.param_specs,
                spec_layout=strategy.spec_layout)
        return optimize_ops, params_grads


class _CollectiveFleet(Fleet):
    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = CollectiveOptimizer(optimizer, strategy)
        return self._optimizer

    def init_worker(self):
        pass

    def init_server(self, model_dir=None):
        raise RuntimeError("collective fleet has no servers")

    def run_server(self):
        raise RuntimeError("collective fleet has no servers")

    def stop_worker(self):
        pass


#: module-level singleton, same usage shape as the reference's
#: `from paddle.fluid.incubate.fleet.collective import fleet`
fleet = _CollectiveFleet()
