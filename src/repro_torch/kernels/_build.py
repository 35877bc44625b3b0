"""Build the CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):
``build/kernels/<stem>-<hash>.so`` under the repository root, keyed by the
content of the source and of the headers beside it.  :func:`build` starts
one ``nvcc`` per source, all at once, and returns each one's ``-Xptxas -v``
report (registers, shared memory, spills).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Sequence

#: Where the libraries go: ``build/kernels`` at the repository root.
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_NVCC_TIMEOUT_S = 600
_LOADED: Dict[pathlib.Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` on the PATH, else the toolkit's default place; raise if
    neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def library_path(source: pathlib.Path) -> pathlib.Path:
    """The library a source builds into (its name carries a content hash
    of the source and the headers next to it)."""
    digest = hashlib.sha256()
    for part in [source, *sorted(source.parent.glob("*.cuh"))]:
        digest.update(part.name.encode())
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Sequence[pathlib.Path]) -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{stem: ptxas report}``; a library built before reports the
    log saved beside it.  Raises with nvcc's output if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports: Dict[str, str] = {}
    running = []
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            log = lib.with_suffix(".log")
            reports[source.stem] = log.read_text() if log.exists() else ""
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, tmp, proc))
    failures = []
    for source, lib, tmp, proc in running:
        try:
            out, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"{source.name}: nvcc timed out\n{out}")
            continue
        if proc.returncode != 0:
            failures.append(f"{source.name}: nvcc exit {proc.returncode}\n"
                            f"{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
        reports[source.stem] = out
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return reports


def load(source: pathlib.Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _LOADED[source] = lib
        return lib
