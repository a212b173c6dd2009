"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

A source under ``csrc/`` builds at first use into ``_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads the existing library.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded = {}


class BuildError(RuntimeError):
    pass


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise BuildError("nvcc not found on PATH or under /usr/local/cuda/bin; "
                     "the CUDA kernels build only where the CUDA toolkit is")


def library_path(source):
    """Where the library for ``source`` (a file name under ``csrc/``)
    lands: named by a hash of the source text and the flags."""
    text = (CSRC / source).read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{tag}.so"


def build(source):
    """Compile ``source`` unless its library exists. Returns nvcc's output
    (``-Xptxas -v``: registers, shared memory, spills), empty when the
    library already existed; raises ``BuildError`` when nvcc fails."""
    path = library_path(source)
    if path.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed for {source} (exit {proc.returncode}):"
                         f"\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return proc.stdout


def load(source):
    """The loaded ``ctypes.CDLL`` for ``source``, building it first when
    its library is missing."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build(source)
            lib = _loaded[source] = ctypes.CDLL(str(library_path(source)))
        return lib


def function(source, name, argtypes, restype=ctypes.c_int):
    """``source``'s C function ``name`` with its argument and result types
    declared (ctypes would pass an undeclared pointer as a 32-bit int).
    Callers resolve it once and keep it: the lookup is no per-launch cost."""
    fn = getattr(load(source), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def raw_stream_getter():
    """PyTorch's getter of a card's current stream as an int (the
    ``cudaStream_t``): ``getter(device_index)``. Read on every launch,
    since a caller may set another stream; far cheaper than building a
    ``torch.cuda.Stream``. A CPU build of PyTorch has none, so it is
    resolved here, at the first launch, and not at import."""
    import torch

    return torch._C._cuda_getCurrentRawStream
