"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on first use into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC --ptxas-options=-v -o lib<name>.so <name>.cu

and is loaded with ``ctypes``. Libraries go into ``kernels/.build/<key>/``
(listed in ``.gitignore``), where ``key`` hashes the sources and the
flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them. ``nvcc``'s resource report (``--ptxas-options=-v``) is kept beside
each library as ``lib<name>.log``.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all() -> float:
    """Compile every kernel source not yet built, all ``nvcc`` processes
    at once. Returns the wall seconds spent. Raises with ``nvcc``'s
    output if any build fails."""
    t0 = time.perf_counter()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources() if not _lib_path(s.stem).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = _nvcc()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"lib{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{src.name} (rc {proc.returncode}):\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(src.stem))   # atomic publish
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building the kernels first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        msg = lib.repro_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg}) at launch")
