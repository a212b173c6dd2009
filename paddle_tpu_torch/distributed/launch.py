"""Multi-process launcher.

Reference: python/paddle/distributed/launch.py — spawns one worker
process per device (start_procs :175), injecting PADDLE_TRAINER_ID /
PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS (:105-109); the JAX
package's ``paddle_tpu/distributed/launch.py`` keeps that env contract.
Here the unit of launch is one process per rank (the torch idiom, where
the JAX package launches one per host), and the rendezvous of
``torch.distributed`` is ``PADDLE_DIST_INIT_METHOD``: by default a
``file://`` store in a fresh temp dir, so gangs launched side by side
never collide on a port. On a machine with one card, every rank shares
it (``parallel.env.default_backend`` then picks gloo).

A gang is all-or-nothing: one crashed rank wedges every collective, so
``wait_gang`` polls the whole gang and terminates the survivors the
moment any rank exits nonzero.

Usage:  python -m paddle_tpu_torch.distributed.launch --nproc 2 train.py [args...]
"""

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from paddle_tpu_torch.parallel.env import INIT_METHOD_ENV

__all__ = ["spawn_gang", "wait_gang", "terminate_gang", "launch_procs",
           "main"]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_gang(script_args, nproc=1, started_port=None, init_method=None,
               extra_env=None, ranks=None):
    """Spawn one process per rank running ``script_args`` (a script path
    and its arguments) with the fleet env contract injected; returns the
    ``Popen`` handles in ``ranks`` order (default: the whole gang).
    ``init_method`` is the process group's rendezvous (default:
    ``tcp://`` at the first endpoint)."""
    started_port = started_port or _free_port()
    endpoints = ",".join(f"127.0.0.1:{started_port + i}" for i in range(nproc))
    init_method = init_method or f"tcp://127.0.0.1:{started_port}"
    # make the framework importable in workers even when not pip-installed
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for rank in (range(nproc) if ranks is None else ranks):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p)
        env.update(extra_env or {})
        env.update({
            "TRAINING_ROLE": "TRAINER",
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nproc),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT": f"127.0.0.1:{started_port + rank}",
            INIT_METHOD_ENV: init_method,
        })
        procs.append(subprocess.Popen([sys.executable] + list(script_args),
                                      env=env))
    return procs


def terminate_gang(procs, grace_s=5.0):
    """TERM every live rank, give them ``grace_s`` to exit, then KILL."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def wait_gang(procs, fail_fast=True, poll_interval_s=0.1, grace_s=5.0,
              timeout_s=None):
    """Poll all ranks until the gang resolves; returns exit codes in rank
    order. With ``fail_fast``, the first nonzero exit terminates the
    survivors at once (they would otherwise hang on dead collectives);
    their codes then reflect the termination signal. Past ``timeout_s``
    the whole gang is terminated."""
    failed = False
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            return codes
        if not failed and ((fail_fast and any(c not in (None, 0)
                                               for c in codes))
                           or (deadline is not None
                               and time.monotonic() > deadline)):
            failed = True
            terminate_gang(procs, grace_s=grace_s)
            continue
        time.sleep(poll_interval_s)


def launch_procs(script_args, nproc=1, started_port=None, init_method=None,
                 extra_env=None, fail_fast=True, timeout_s=None):
    """Spawn a gang and wait for it; returns the exit codes. Without an
    ``init_method`` the ranks meet at a ``file://`` store in a temp dir of
    their own, removed afterwards."""
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_rdzv_")
        init_method = "file://" + os.path.join(tmp, "store")
    procs = spawn_gang(script_args, nproc=nproc, started_port=started_port,
                       init_method=init_method, extra_env=extra_env)

    def _terminate(signum, frame):
        for p in procs:
            p.terminate()

    old = signal.signal(signal.SIGTERM, _terminate)
    try:
        return wait_gang(procs, fail_fast=fail_fast, timeout_s=timeout_s)
    finally:
        signal.signal(signal.SIGTERM, old)
        terminate_gang(procs)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    parser.add_argument("--nproc", type=int, default=1,
                        help="processes (ranks) to launch on this machine")
    parser.add_argument("--started_port", type=int, default=None)
    parser.add_argument("--init_method", type=str, default=None,
                        help="torch.distributed rendezvous (default: a "
                             "file:// store in a fresh temp dir)")
    parser.add_argument("script", type=str)
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    codes = launch_procs([args.script] + args.script_args, nproc=args.nproc,
                         started_port=args.started_port,
                         init_method=args.init_method)
    bad = [i for i, c in enumerate(codes) if c != 0]
    if bad:
        sys.exit(f"workers {bad} exited nonzero: {[codes[i] for i in bad]}")


if __name__ == "__main__":
    main()
