"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on first use
into ``build/lib<name>-<hash>.so`` at the repository root, with one
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
per source; :func:`build_all` starts all of them together.  The file name
carries a hash of the source and of every ``csrc`` header it includes
(``#include "hopper.cuh"``, followed through headers that include others),
so an edited kernel or header is rebuilt and a stale library is never
loaded.  The compiler's own output (``-Xptxas -v``:
registers, shared memory, spills) and the build's wall time are kept
beside it as ``.log``.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _inputs(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through other headers, in a fixed order."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return [seen[0]] + sorted(seen[1:])


def lib_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(ARCH_FLAGS + FLAGS).encode())
    for path in _inputs(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    out = lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *ARCH_FLAGS, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, tmp, out, cmd, t0 = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(
        f"{' '.join(cmd)}\nbuild_seconds {time.perf_counter() - t0:.2f}\n{log}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)         # atomic: a concurrent loader sees all or none


def build_all() -> Dict[str, Path]:
    """Compile every kernel source that has no current library, in parallel."""
    jobs = {n: _start(n) for n in sources()}
    # one waiting thread a job, so each log's time is its own build's
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        done = [pool.submit(_finish, n, j) for n, j in jobs.items()
                if j is not None]
    errors = [str(f.exception()) for f in done if f.exception() is not None]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: lib_path(n) for n in jobs}


def build_log(name: str) -> str:
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(lib_path(name)))
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
