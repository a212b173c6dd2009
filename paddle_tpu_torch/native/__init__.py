"""Host-side native components: the parameter server (``csrc/ps.cc``) and
the MultiSlot data feed (``csrc/datafeed.cc``).

Both sources are byte-for-byte copies of the JAX package's
``csrc/ps/ps.cc`` and ``csrc/datafeed/datafeed.cc``, so the per-id row
init (``mt19937`` seeded from the id), the wire protocol and the table
file format are the same in both packages. Each builds with ``g++`` at
first use into ``_build/`` (listed in ``.gitignore``) through
``kernels/build.py``'s cache: named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads the
library that is there. Nothing is written beside the sources. Bindings
are ``ctypes``.
"""

from pathlib import Path

from paddle_tpu_torch.kernels import build as _build

__all__ = ["NativeBuildError", "build_native", "load_native",
           "library_path", "CSRC", "BUILD_DIR", "GXX_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

NativeBuildError = _build.BuildError


def _how(component):
    source = f"{component}.cc"
    if not (CSRC / source).exists():
        raise NativeBuildError(f"no source for native component {component}")
    return source, dict(csrc=CSRC, build_dir=BUILD_DIR, compiler="g++",
                        flags=GXX_FLAGS)


def library_path(component):
    """Where ``component``'s library lands."""
    source, how = _how(component)
    return _build.library_path(source, how["csrc"], how["build_dir"],
                               how["flags"])


def build_native(component):
    """Compile ``component`` unless its library exists (no lock: builds
    of different components may run side by side). Returns g++'s output."""
    source, how = _how(component)
    return _build.build(source, **how)


def load_native(component):
    """Build (when its library is missing) and load ``component``
    (``"ps"`` or ``"datafeed"``). Returns a ``ctypes.CDLL``; raises
    ``NativeBuildError`` when there is no source or ``g++`` fails."""
    source, how = _how(component)
    return _build.load(source, **how)
