"""Distributed launch utilities (reference: python/paddle/distributed/).
The launcher is ``paddle_tpu_torch.distributed.launch``
(``python -m paddle_tpu_torch.distributed.launch --nproc N script.py``);
``launch_procs`` is loaded from it on first use, so running that module
with ``-m`` does not import it twice."""

from paddle_tpu_torch.parallel.env import ParallelEnv, make_mesh  # noqa: F401


def __getattr__(name):
    if name == "launch_procs":
        from paddle_tpu_torch.distributed.launch import launch_procs

        return launch_procs
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
