"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` (the hash is of
the source and the shared ``csrc/*.cuh`` headers, so an edited kernel
rebuilds) at its first use, and loaded with ``ctypes``.  Nothing is built or loaded when the module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and the shared
    headers (``csrc/*.cuh``) it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, ptxas_verbose: bool):
    """Start ``nvcc`` for one source; None when it is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for one ``nvcc``; move its library into place or raise."""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc exited {proc.returncode} for {name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build_all(ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built, one ``nvcc`` per source, all
    started together.  Returns ``{name: compiler output}`` of the sources
    compiled in this call."""
    jobs = {n: _start(n, ptxas_verbose) for n in sources()}
    logs, errors = {}, []
    for name, job in jobs.items():
        if job is None:
            continue
        try:
            logs[name] = _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name, False)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


@contextlib.contextmanager
def replaced(name: str, lib: ctypes.CDLL):
    """Within the block, ``load(name)`` returns ``lib`` (another build of
    ``csrc/<name>.cu``, for example an edited copy being timed); the loaded
    library, if any, is put back after."""
    before = _LIBS.get(name)
    _LIBS[name] = lib
    try:
        yield lib
    finally:
        if before is None:
            _LIBS.pop(name, None)
        else:
            _LIBS[name] = before
