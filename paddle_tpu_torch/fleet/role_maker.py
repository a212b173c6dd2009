"""Role makers: cluster-topology discovery for Fleet, the counterpart of
the JAX package's ``fleet/role_maker.py``.

The analog of the reference's role makers (reference:
python/paddle/fluid/incubate/fleet/base/role_maker.py —
PaddleCloudRoleMaker :441 reads PADDLE_* env vars, UserDefinedRoleMaker
:876). The reference also ships an MPI role maker (:225); here the
rendezvous belongs to ``torch.distributed`` (the launcher's
``PADDLE_DIST_INIT_METHOD``, the analog of the gen_nccl_id RPC
bootstrap, reference: paddle/fluid/operators/collective/
c_gen_nccl_id_op.cc), so role makers only need env/user-supplied
topology.
"""

import os

__all__ = [
    "Role",
    "RoleMakerBase",
    "PaddleCloudRoleMaker",
    "UserDefinedRoleMaker",
    "UserDefinedCollectiveRoleMaker",
]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role_is_generated = False

    def generate_role(self):
        self._role_is_generated = True

    def _ensure_generated(self):
        if not self._role_is_generated:
            self.generate_role()

    def is_worker(self):
        self._ensure_generated()
        return self._role == Role.WORKER

    def is_server(self):
        self._ensure_generated()
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self.worker_index() == 0

    def worker_index(self):
        self._ensure_generated()
        return self._current_id if self._role == Role.WORKER else -1

    def server_index(self):
        self._ensure_generated()
        return self._current_id if self._role == Role.SERVER else -1

    def worker_num(self):
        self._ensure_generated()
        return max(len(self._worker_endpoints), 1)

    def server_num(self):
        self._ensure_generated()
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        self._ensure_generated()
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self):
        self._ensure_generated()
        return list(self._server_endpoints)


class PaddleCloudRoleMaker(RoleMakerBase):
    """Discover the role from PADDLE_* environment variables (the contract
    set by fleet launch; reference: role_maker.py:441 and launch.py:105-109).

    TRAINING_ROLE=TRAINER|PSERVER selects worker/server; collective jobs
    only set trainer vars.
    """

    def __init__(self, is_collective=True):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        if self._role_is_generated:
            return
        training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
        self._worker_endpoints = [
            e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",") if e
        ]
        self._server_endpoints = [
            e
            for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "").split(",")
            if e
        ]
        if training_role == "PSERVER":
            self._role = Role.SERVER
            cur = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
            self._current_id = (
                self._server_endpoints.index(cur)
                if cur in self._server_endpoints
                else int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            )
        else:
            self._role = Role.WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            if not self._worker_endpoints:
                n = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
                self._worker_endpoints = [""] * n
        self._role_is_generated = True


class UserDefinedRoleMaker(RoleMakerBase):
    """Explicit topology (reference: role_maker.py:876)."""

    def __init__(
        self,
        current_id=0,
        role=Role.WORKER,
        worker_num=1,
        server_endpoints=None,
        worker_endpoints=None,
    ):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._server_endpoints = list(server_endpoints or [])
        self._worker_endpoints = list(worker_endpoints or [""] * worker_num)

    def generate_role(self):
        self._role_is_generated = True


class UserDefinedCollectiveRoleMaker(RoleMakerBase):
    """Collective-only explicit topology (reference: role_maker.py:952)."""

    def __init__(self, current_id=0, worker_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = Role.WORKER
        self._worker_endpoints = list(worker_endpoints or [""])

    def generate_role(self):
        self._role_is_generated = True
