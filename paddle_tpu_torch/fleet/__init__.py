"""Fleet: the unified distributed-training API, the counterpart of the
JAX package's ``fleet/`` in its collective mode.

Reference: python/paddle/fluid/incubate/fleet/ — the Fleet facade
(base/fleet_base.py:38), role makers (base/role_maker.py) and collective
mode (collective/__init__.py). The parameter-server mode is
``fleet.parameter_server`` (its own ``fleet`` object, as in the JAX
package). Collective usage, one process per rank under
``python -m paddle_tpu_torch.distributed.launch --nproc N train.py``:

    from paddle_tpu_torch.fleet import fleet, DistributedStrategy
    fleet.init(role_maker)
    opt = fleet.distributed_optimizer(fluid.optimizer.Adam(1e-4), strategy)
    opt.minimize(loss)
    exe.run(fleet.main_program, feed=..., fetch_list=...)
"""

from paddle_tpu_torch.fleet.base import DistributedOptimizer, Fleet
from paddle_tpu_torch.fleet.collective import (
    CollectiveOptimizer,
    DistributedStrategy,
    fleet,
)
from paddle_tpu_torch.fleet import role_maker
from paddle_tpu_torch.fleet.role_maker import (
    PaddleCloudRoleMaker,
    Role,
    RoleMakerBase,
    UserDefinedCollectiveRoleMaker,
    UserDefinedRoleMaker,
)

__all__ = [
    "fleet",
    "Fleet",
    "DistributedOptimizer",
    "CollectiveOptimizer",
    "DistributedStrategy",
    "role_maker",
    "Role",
    "RoleMakerBase",
    "PaddleCloudRoleMaker",
    "UserDefinedRoleMaker",
    "UserDefinedCollectiveRoleMaker",
]
