"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

A source under ``csrc/`` builds at first use into ``_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads the existing library.
The host components of ``paddle_tpu_torch/native`` build through the same
cache with ``g++``: ``library_path``, ``build`` and ``load`` take the
source directory, the build directory, the compiler and its flags.
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


def library_path(source, csrc=CSRC, build_dir=BUILD_DIR, flags=NVCC_FLAGS):
    """Where the library for ``source`` (a file name under ``csrc``)
    lands: named by a hash of the source text and the flags."""
    text = (csrc / source).read_bytes()
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir / f"lib{Path(source).stem}-{tag}.so"


def build(source, csrc=CSRC, build_dir=BUILD_DIR, compiler=None,
          flags=NVCC_FLAGS):
    """Compile ``source`` with ``compiler`` (default nvcc) unless its
    library exists. Returns the compiler's output (nvcc's ``-Xptxas -v``:
    registers, shared memory, spills), empty when the library already
    existed; raises ``BuildError`` when the compiler is missing or fails."""
    path = library_path(source, csrc, build_dir, flags)
    if path.exists():
        return ""
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    compiler = compiler or nvcc_path()
    try:
        proc = subprocess.run(
            [compiler, *flags, "-o", str(tmp), str(csrc / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise BuildError(f"{compiler} unavailable: {e}") from e
    if proc.returncode != 0:
        raise BuildError(f"{Path(compiler).name} failed for {source} (exit "
                         f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return proc.stdout


def load(source, csrc=CSRC, build_dir=BUILD_DIR, compiler=None,
         flags=NVCC_FLAGS):
    """The loaded ``ctypes.CDLL`` for ``source``, building it first when
    its library is missing."""
    with _lock:
        lib = _loaded.get(csrc / source)
        if lib is None:
            build(source, csrc, build_dir, compiler, flags)
            lib = _loaded[csrc / source] = ctypes.CDLL(
                str(library_path(source, csrc, build_dir, flags)))
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
