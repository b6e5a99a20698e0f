"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library under
``build/torch_kernels/`` at the repository root, the first time a kernel
is used.  The sources share device code through the headers
``csrc/*.cuh``.  The library's file name carries a hash of the source,
every header and the flags, so an edited source or header rebuilds and a
stale library is never loaded.
A failed build raises `KernelBuildError` with the compiler's output;
nothing falls back to the plain PyTorch version.

The ptxas report (registers, shared memory, spills; ``-Xptxas -v``) of
each build is kept beside the library and returned by `ptxas_report`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc failed or is missing."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    (path, process) pair, process None when nothing needs building."""
    path = _lib_path(name)
    if path.exists():
        return path, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return path, (proc, tmp)


def _finish(name: str, path: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp = pending
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{out}")
    path.with_suffix(".ptxas.txt").write_text(out)
    os.replace(tmp, path)  # atomic: concurrent builders never load half a file


def build(names) -> dict[str, Path]:
    """Build every named kernel, one nvcc per source, all started together."""
    started = {name: _start(name) for name in names}
    for name, (path, pending) in started.items():
        _finish(name, path, pending)
    return {name: path for name, (path, _) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


def ptxas_report(name: str) -> str:
    """ptxas's register, shared-memory and spill lines of the built kernel."""
    path = _lib_path(name).with_suffix(".ptxas.txt")
    text = path.read_text() if path.exists() else ""
    return "\n".join(
        line.strip() for line in text.splitlines() if "ptxas info" in line or "spill" in line
    )
