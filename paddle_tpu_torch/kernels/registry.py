"""Kernel registry: which hand-written CUDA kernels exist, whether ops use
them, and how many times each was launched.

Modes, from ``PADDLE_TPU_TORCH_KERNELS`` or ``scoped_mode``:

* ``auto`` (default) — a kernel-backed op launches its CUDA kernel on
  CUDA tensors; on CPU tensors the wrapper computes the kernel's plain
  PyTorch version (that is the CPU path, not a fallback).
* ``off`` — every kernel-backed op computes the plain version, on any
  device. It is the caller's explicit opt-out, the counterpart of the
  JAX package's ``PADDLE_TPU_KERNELS=off``; nothing switches to it on its
  own when a build or a launch fails — those raise.

Each wrapper calls ``note_launch`` once per kernel launch and nowhere
else, so ``launches()`` shows whether a run really went through the
kernels.

A kernel that checks its input on the card, without a sync, reports a
bad input after its launch: its module registers the check with
``report_late``, and ``raise_late`` (called by ``Executor.run`` once the
card has run the launch) raises what it found.
"""

import os
import threading
from collections import namedtuple

__all__ = ["KERNELS", "MODE_ENV", "mode", "scoped_mode", "note_launch",
           "launches", "reset_launches", "report_late", "late_launches",
           "raise_late"]

MODE_ENV = "PADDLE_TPU_TORCH_KERNELS"
_MODES = ("auto", "off")

#: one entry per wrapper: the CUDA source it launches (repo-relative)
#: and the JAX package's Pallas kernel it replaces (K8 replaces the code
#: XLA generates for ``jax.random``, which has no Pallas kernel)
KernelInfo = namedtuple("KernelInfo", ["source", "replaces"])

KERNELS = {
    "paged_attention": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        "paddle_tpu/kernels/attention.py:122"),
    "decode_attention": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        "paddle_tpu/kernels/attention.py:122"),
    "flash_attention_fwd": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:167"),
    "flash_attention_bwd_dkdv": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:378"),
    "flash_attention_bwd_dq": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:419"),
    "embedding_admission": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/embedding_admission.cu",
        "paddle_tpu/kernels/embedding.py:105"),
    "sparse_row_update": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/sparse_update.cu",
        "paddle_tpu/ops/pallas/sparse_update.py:57"),
    "blocked_topk_abs": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/topk.cu",
        "paddle_tpu/ops/pallas/topk.py:66"),
    "threefry_random_bits": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/threefry.cu",
        "XLA's threefry2x32 under jax.random (no Pallas kernel)"),
    "threefry_dropout": KernelInfo(
        "paddle_tpu_torch/kernels/csrc/threefry.cu",
        "XLA's threefry2x32 under jax.random (no Pallas kernel)"),
}
# the bf16 and float16 builds of K1, K2a and K2b (AMP's operand types)
# count their launches under their own names
KERNELS.update({
    f"{name}_{suffix}": KERNELS[name]
    for suffix in ("bf16", "f16")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq")
})

_lock = threading.Lock()
_mode_stack = []
_launches = {name: 0 for name in KERNELS}
_late = {}      # kernel name -> check(device), see report_late


def mode():
    """The innermost ``scoped_mode``, else the env var, else ``auto``.
    An unknown value raises: a typo must not silently change the path."""
    with _lock:
        if _mode_stack:
            return _mode_stack[-1]
    raw = os.environ.get(MODE_ENV, "").strip().lower() or "auto"
    if raw not in _MODES:
        raise ValueError(f"{MODE_ENV}={raw!r}: unknown mode (want one of {_MODES})")
    return raw


class scoped_mode:
    """Swap the process-wide kernel mode for a ``with`` block. Not
    thread-local: an engine's scheduler thread sees the same mode."""

    def __init__(self, m):
        if m not in _MODES:
            raise ValueError(f"unknown kernel mode {m!r} (want {_MODES})")
        self._m = m

    def __enter__(self):
        with _lock:
            _mode_stack.append(self._m)
        return self

    def __exit__(self, *exc):
        with _lock:
            _mode_stack.pop()
        return False


def note_launch(name):
    with _lock:
        _launches[name] += 1


def launches(name=None):
    """Launch count of one kernel, or a dict of all counts."""
    with _lock:
        return _launches[name] if name is not None else dict(_launches)


def reset_launches():
    with _lock:
        for name in _launches:
            _launches[name] = 0


def report_late(name, check):
    """Kernel ``name`` reports a bad input after its launch:
    ``check(device)`` raises the ``ValueError`` of what its launches on
    ``device`` met since the last check (and clears it), once the card has
    run them; it makes no sync."""
    _late[name] = check


def late_launches():
    """Launches so far of the kernels that report late."""
    with _lock:
        return sum(_launches[name] for name in _late)


def raise_late(device):
    """Raise the first bad input that a late-reporting kernel met on
    ``device`` (the caller has synced with the card since the launch)."""
    for check in list(_late.values()):
        check(device)
