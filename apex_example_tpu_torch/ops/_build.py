"""Build the port's CUDA sources into shared libraries and load them.

The route: ``nvcc`` compiles each ``csrc/<name>.cu`` for ``sm_90a`` into a
shared library with a plain C interface, which ``ctypes`` loads; pointers
and the stream cross as ``c_void_p``.  No source includes PyTorch's
headers, so a build takes seconds where a PyTorch C++ extension takes
minutes.

A library is built at first use into ``build/kernels/`` at the root of the
checkout (listed in .gitignore), under a name that hashes its source and
the compile flags: an edited source builds anew, an unchanged one loads
from disk.  Nothing is compiled or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}       # guarded-by: _lock


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default
    /usr/local/cuda), else the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are compiled on the machine with the card")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc``
    process per source, all started together.  Returns name -> the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    for the sources compiled by this call; raises if any compile fails,
    after every started process has ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in started.items():
        text, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
            reports[name] = text
        else:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                            f"{text}")
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
