"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``src/repro_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process (all started together) into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

at first use, into ``build/`` at the repository root, keyed by a hash of
the source and the flags, so an unchanged source is never rebuilt.  Each C
entry point returns ``cudaGetLastError()`` after its launch; the Python
wrappers raise when it is non-zero.  Without ``nvcc`` this raises: there
is no other way to get a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_STATS = {"hits": 0, "misses": 0}
#: per-source compiler output (ptxas register / spill report) of the last
#: build in this process
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            f"{CSRC} with the CUDA toolkit, which this machine lacks")
    return path


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every source whose library is missing, in parallel, and
    return ``{name: library path}``.  Raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in sources}
    todo = [s for s in sources if not targets[s.stem].exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for s in todo:
            tmp = targets[s.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for s, tmp, p in procs:
            out, _ = p.communicate()
            BUILD_LOG[s.stem] = out
            if p.returncode != 0:
                failed.append(f"{s.name} (exit {p.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, targets[s.stem])      # atomic publish
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use together with every other source)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all()[name]
            lib = _LIBS[name] = ctypes.CDLL(str(path))
            _STATS["misses"] += 1
        else:
            _STATS["hits"] += 1
        return lib


def cache_stats() -> dict[str, int]:
    """Lookups of :func:`library` that found a loaded library (hits) and
    that loaded one (misses), and the libraries loaded (entries)."""
    with _LOCK:
        return dict(_STATS, entries=len(_LIBS))


def clear_cache() -> None:
    """Drop the loaded libraries and zero :func:`cache_stats`."""
    with _LOCK:
        _LIBS.clear()
        _STATS["hits"] = _STATS["misses"] = 0
