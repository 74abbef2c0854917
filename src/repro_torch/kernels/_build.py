"""Build and load the hand-written CUDA kernels (``*/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). A library is built at first use into
``build/torch_kernels/`` at the repo root; its file name carries a hash of
the source, of the shared headers (``include/*.cuh``) and of the flags, so
an edited source or header is rebuilt and a stale library is never
loaded. :func:`build_all` starts one ``nvcc`` per source,
all at once. A failed build raises with nvcc's stderr.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

def sources() -> list[Path]:
    """Every kernel source of the package, in a stable order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def headers() -> list[Path]:
    """The headers the sources share (``include/*.cuh``), in a stable order."""
    return sorted((KERNELS_DIR / "include").glob("*.cuh"))


def library_path(src: Path) -> Path:
    """Where the library built from ``src`` lives; keyed by the content of
    ``src`` and of every shared header, and by the flags."""
    digest = hashlib.sha256(Path(src).read_bytes())
    for header in headers():
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{digest.hexdigest()[:16]}.so"


def nvcc() -> str:
    """Path of ``nvcc``; raises where the CUDA toolkit is absent."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (/usr/local/cuda)")
    return found


def build_all(srcs: list[Path] | None = None) -> dict[Path, str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Returns ``{source: nvcc's stderr}`` for the
    sources built now (ptxas's register and spill report)."""
    todo = [Path(s) for s in (sources() if srcs is None else srcs)
            if not library_path(s).exists()]
    if not todo:
        return {}
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = {}, []
    for src, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)      # atomic: a reader never sees half a file
        logs[src] = stderr
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


@functools.cache
def load(src: Path) -> ctypes.CDLL:
    """The library built from ``src`` (built first if needed); a process
    loads each library once."""
    build_all([src])
    lib = ctypes.CDLL(str(library_path(src)))
    # every source exports this beside its launch function
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
