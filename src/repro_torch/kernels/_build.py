"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
-Xptxas -v``. Libraries land in ``build/torch_kernels/`` at the repository
root, named by a hash of the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one loads as built; the compiler's
output (ptxas's registers, spills and shared memory per kernel) is kept
beside each library and read by :func:`ptxas_info`. The first call that
needs a kernel builds it; :func:`build` starts every missing build at once,
one ``nvcc`` per source. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "load", "build_dir", "ptxas_info"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"block_combine": "block_combine.cu", "quantize": "quantize.cu",
           "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    tag = h.hexdigest()[:16]
    return build_dir() / f"lib{name}-{tag}.so"


def build(names=None) -> dict:
    """Compile every named library that is not built yet, all ``nvcc`` runs
    started together. Returns ``{name: seconds}`` for the ones it built;
    raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    with _LOCK:
        return _build_locked(names)


def _build_locked(names) -> dict:
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with ``argtypes``
    and ``restype`` set from ``signatures``: ``{fn: (argtypes, restype)}``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = argtypes, restype
            _LIBS[name] = lib
        return lib


def ptxas_info(name: str, kernel: str) -> list[str]:
    """ptxas's report for each entry function of library ``name`` whose
    mangled name holds ``kernel``, one line each: the function, then its
    stack, spills, registers and shared memory, and any note ptxas gave it
    (such as wgmma instructions it had to serialize)."""
    log = _lib_path(name).with_suffix(".log").read_text()
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
            cur = [fn] if kernel in fn else None
            if cur is not None:
                out.append(cur)
        elif cur is not None and line.strip() and \
                "Function properties" not in line:
            cur.append(line.split(":", 1)[-1].strip()
                       if line.startswith("ptxas") else line.strip())
    return ["; ".join(c) for c in out]
