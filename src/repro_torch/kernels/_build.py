"""Build the CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):
``build/kernels/<stem>-<hash>.so`` under the repository root, keyed by the
content of the source and of every header it includes with quotes, in
its own directory or elsewhere (``kernels/csrc/mma_sync.cuh``), so that an
edit to a shared header rebuilds every source that includes it.  :func:`build` starts
one ``nvcc`` per source, all at once, and returns each one's ``-Xptxas -v``
report (registers, shared memory, spills) followed by :func:`sass_report`'s
lines.  ptxas's ``-v`` line gives the registers a thread holds at launch;
a kernel whose warpgroups trade registers with ``setmaxnreg`` runs its
consumers on more, which only the SASS shows.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, Sequence

#: Where the libraries go: ``build/kernels`` at the repository root.
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_NVCC_TIMEOUT_S = 600
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)
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


def included_headers(source: pathlib.Path) -> list:
    """Every header that ``source`` includes with quotes, directly or
    through another header, each resolved beside the file that names it
    (as nvcc resolves them), in a fixed order."""
    found: Dict[pathlib.Path, None] = {}
    todo = [source]
    while todo:
        current = todo.pop()
        for name in _INCLUDE.findall(current.read_text()):
            header = (current.parent / name).resolve()
            if header not in found:
                found[header] = None
                todo.append(header)
    return sorted(found)


def library_path(source: pathlib.Path) -> pathlib.Path:
    """The library a source builds into (its name carries a content hash
    of the source and of every header it includes)."""
    digest = hashlib.sha256()
    for part in [source, *included_headers(source)]:
        digest.update(part.name.encode())
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def cuobjdump_path() -> str:
    """``cuobjdump`` beside ``nvcc``, else on the PATH; "" if neither."""
    try:
        beside = pathlib.Path(nvcc_path()).with_name("cuobjdump")
    except RuntimeError:
        beside = None
    if beside is not None and beside.exists():
        return str(beside)
    return shutil.which("cuobjdump") or ""


_FUNCTION = re.compile(r"^\s*Function : (\S+)", re.MULTILINE)
_REGISTER = re.compile(r"(?<![A-Za-z_])R(\d+)\b")
_SETMAXNREG = re.compile(r"USETMAXREG\S*\s[^;]*")
_LOCAL = re.compile(r"\b(LDL|STL)(?=[.\s])")


def sass_summary(sass: str) -> list:
    """Per function of ``cuobjdump -sass`` output: ``(name, registers,
    setmaxnreg, local loads, local stores)``, where ``registers`` is one
    more than the highest register (``R<n>``) its code names, which is
    what a warp running its widest part holds, and ``setmaxnreg`` the
    distinct ``USETMAXREG`` instructions."""
    rows = []
    parts = _FUNCTION.split(sass)
    for name, body in zip(parts[1::2], parts[2::2]):
        regs = [int(r) for r in _REGISTER.findall(body)]
        local = _LOCAL.findall(body)
        rows.append((name, max(regs) + 1 if regs else 0,
                     sorted({" ".join(m.split()) for m in
                             _SETMAXNREG.findall(body)}),
                     local.count("LDL"), local.count("STL")))
    return rows


def sass_report(lib: pathlib.Path) -> str:
    """``sass:`` lines for every kernel of a built library (one per
    function of :func:`sass_summary`), or "" where ``cuobjdump`` is
    missing."""
    tool = cuobjdump_path()
    if not tool:
        return ""
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=_NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        return f"sass: cuobjdump exit {proc.returncode}: {proc.stderr}\n"
    return "".join(
        f"sass: {name}: {regs} registers named; setmaxnreg "
        f"{'; '.join(setmax) or 'none'}; local loads {ldl}, stores {stl}\n"
        for name, regs, setmax, ldl, stl in sass_summary(proc.stdout))


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
        out += sass_report(tmp)
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
