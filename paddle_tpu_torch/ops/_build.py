"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its
own shared library with a plain C interface,
``build/paddle_tpu_torch/<hash>/lib<name>.so`` under the repository
root, where ``<hash>`` covers every source and header in ``csrc/`` and
the compiler flags, so an edited source rebuilds and an unchanged one
loads at once. All sources compile in parallel, one ``nvcc`` each.
Libraries load with ``ctypes``; every pointer argument and the stream
are ``c_void_p``, and every C entry returns ``cudaGetLastError()``,
which ``check`` turns into an exception.

Nothing here runs at import: the first ``load`` builds. A failed build
raises; no caller falls back to a plain PyTorch path on a CUDA tensor.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

__all__ = ["NVCC_FLAGS", "build_all", "load", "loaded", "check",
           "sources"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once, and
    return kernel name -> library path. Raises on any compiler error,
    with the compiler's output."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in sources()}
    todo = {name: path for name, path in libs.items()
            if not path.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(sources()[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, libs[name])
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" +
                           "\n".join(errors))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def loaded():
    """Names of the kernel libraries this process has loaded so far."""
    with _LOCK:
        return sorted(_LIBS)


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise when a C entry reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.pt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
