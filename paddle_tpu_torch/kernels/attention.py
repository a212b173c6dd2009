"""Decode attention: paged (block-arena) and cached (dense slotted) forms.

The JAX package serves both with one-program Pallas kernels whose bodies
are the plain composites (``paddle_tpu/kernels/attention.py``). Here:

* ``paged_attention_composite`` / ``cached_attention_composite`` — the
  plain PyTorch versions, the same primitive sequence as the JAX
  package's composites. The op registry's reference lowerings call
  them; so do the wrappers for CPU tensors.
* ``paged_attention`` — the wrapper of the hand-written CUDA kernel in
  ``csrc/paged_attention.cu``: for a CUDA tensor it launches the kernel
  (or raises); for a CPU (or ``meta``) tensor it computes the plain
  version.
* ``decode_attention`` — the same kernel over the dense ``[S, L, H]``
  cache, viewed as a ``[S * L, H]`` arena with identity rows (a null row
  pointer, which the kernel reads as ``row = s * L + p``).

A call is one kernel launch (after a memset of the slots' arrival
counters in the scratch): the block of a slot that finishes last combines
the slot's partials, in split order, so two launches give the same bits.
``split_plan`` sizes the chunks from the slots, the positions and the
card's SM count. The kernel sums in another order than the composite's
matmuls, so the two agree to a stated tolerance (``chip_smoke.py`` checks
it on the card), not bit for bit. The JAX package's VMEM size gate has no
counterpart: the kernel streams rows from device memory at any size.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import registry

__all__ = [
    "cached_attention_composite", "paged_attention_composite",
    "decode_attention", "paged_attention",
]

_SOURCE = "paged_attention.cu"
_CHUNK_STEP, _CHUNK_MAX, _SPLIT_MAX = 16, 8192, 65535
_BLOCKS_PER_SM = 2


def cached_attention_composite(q, k_cache, v_cache, bias, sm_scale):
    """unsqueeze -> matmul(transpose_y, alpha) -> elementwise_add ->
    softmax -> matmul -> squeeze, each step lowered as ops/math.py and
    ops/nn.py lower those ops."""
    q3 = q.unsqueeze(1)                                  # [S,1,H]
    scores = torch.matmul(q3, k_cache.transpose(-1, -2))
    if sm_scale != 1.0:
        scores = scores * sm_scale
    att = torch.softmax(scores + bias, dim=-1)
    return torch.matmul(att, v_cache).squeeze(1)         # [S,H]


def paged_attention_composite(q, k_arena, v_arena, rows, bias, seqs,
                              length, sm_scale):
    """``block_gather(k) ; block_gather(v) ; cached_attention``: gather
    rows out of the flat arenas, then the cached-attention sequence over
    the gathered views."""
    flat = rows.reshape(-1)
    gk = k_arena.index_select(0, flat).reshape(int(seqs), int(length), -1)
    gv = v_arena.index_select(0, flat).reshape(int(seqs), int(length), -1)
    return cached_attention_composite(q, gk, gv, bias, sm_scale)


def _lib():
    lib = build.load(_SOURCE)
    fn = lib.paged_attention_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def split_plan(seqs, length, sms):
    """(chunk, n_split): positions a block takes and blocks a slot gets, for
    ``seqs`` slots of ``length`` positions on a card of ``sms`` SMs. About
    two blocks an SM: each block keeps a few dozen row loads in flight, so
    two of them cover the memory's latency, and fewer, larger chunks leave
    the block that combines a slot fewer partials to read. ``chunk`` is a
    multiple of 16 up to 8192 (the kernel's scores sit in shared memory)
    and ``n_split`` at most 65535, as the C entry point requires."""
    per_block = -(-seqs * length // (_BLOCKS_PER_SM * sms))
    chunk = -(-per_block // _CHUNK_STEP) * _CHUNK_STEP
    chunk = min(_CHUNK_MAX, max(_CHUNK_STEP, chunk))
    n_split = -(-length // chunk)
    if n_split > _SPLIT_MAX:
        raise ValueError(f"{length} positions need more than {_SPLIT_MAX} "
                         f"chunks of {chunk}")
    return chunk, n_split


def scratch_sizes(seqs, n_split, width):
    """Elements of the two float32 scratch tensors the kernel takes: the
    partials' accumulators, and their (max, sum) pairs followed by one
    32-bit arrival counter a slot."""
    return seqs * n_split * width, seqs * n_split * 2 + seqs


def _check(name, t, dtype, device, shape=None, numel=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")


def _launch(name, q, k_arena, v_arena, rows, bias, seqs, length, sm_scale):
    """Launch the kernel; ``rows=None`` means identity rows."""
    dev = q.device
    S, L = int(seqs), int(length)
    H = q.shape[-1]
    R = k_arena.shape[0]
    if H % 4:
        raise ValueError(f"{name}: head width {H} is not a multiple of 4")
    _check("q", q, torch.float32, dev, shape=(S, H))
    _check("k_arena", k_arena, torch.float32, dev, shape=(R, H))
    _check("v_arena", v_arena, torch.float32, dev, shape=(R, H))
    if rows is not None:
        _check("rows", rows, torch.int64, dev, numel=S * L)
    _check("bias", bias, torch.float32, dev, numel=S * L)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, n_split = split_plan(S, L, sms)
    acc_size, ml_size = scratch_sizes(S, n_split, H)
    out = torch.empty((S, H), dtype=torch.float32, device=dev)
    part_acc = torch.empty(acc_size, dtype=torch.float32, device=dev)
    part_ml = torch.empty(ml_size, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_f32(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            None if rows is None else rows.data_ptr(), bias.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), S, L, H, R,
            float(sm_scale), chunk, n_split, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    registry.note_launch(name)
    return out


def paged_attention(q, k_arena, v_arena, rows, bias, seqs, length,
                    sm_scale):
    """Paged attention over the flat ``[R, H]`` arenas: launches the CUDA
    kernel for CUDA tensors (which gathers rows inside the kernel), the
    plain version for CPU or ``meta`` tensors. ``rows`` must lie in
    ``[0, R)``: the plain version raises on a row outside it, the kernel
    clamps it (it reads nothing outside the arena) and the decode engine
    checks its row map before each step, so both devices raise there."""
    if q.device.type != "cuda":
        return paged_attention_composite(q, k_arena, v_arena, rows, bias,
                                         seqs, length, sm_scale)
    return _launch("paged_attention", q, k_arena, v_arena,
                   rows.to(torch.int64), bias, seqs, length, sm_scale)


def decode_attention(q, k_cache, v_cache, bias, sm_scale):
    """Attention of ``q`` ``[S, H]`` over a dense ``[S, L, H]`` cache: the
    paged kernel with identity rows over the ``[S * L, H]`` view."""
    if q.device.type != "cuda":
        return cached_attention_composite(q, k_cache, v_cache, bias,
                                          sm_scale)
    S, L, H = k_cache.shape
    return _launch("decode_attention", q, k_cache.reshape(S * L, H),
                   v_cache.reshape(S * L, H), None, bias, S, L, sm_scale)
