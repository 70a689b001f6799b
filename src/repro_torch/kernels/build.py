"""Builds the CUDA kernels under ``csrc/`` with ``nvcc`` and binds them with
``ctypes``.

Nothing happens at import.  The first call to :func:`library` compiles each
``csrc/*.cu`` into an object — one ``nvcc`` per source, all started together —
and links them into one shared library under ``build/repro_torch/`` at the
repository root, named by a hash of the sources and flags, so a later
process loads it without rebuilding.  The C entries take raw pointers and
the CUDA stream as ``c_void_p`` and return ``cudaGetLastError()`` of their
launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # vsrc vaux lsrc seg w emask partial counts T ET ST RT K A gen monoid ident stream
    "gx_csr_tile": [_P] * 8 + [_I] * 8 + [_F, _P],
    # vstate vaux lsrc ldst w emask partial counts staging nb B VB K A gen
    # monoid ident stream
    "gx_edge_block": [_P] * 9 + [_I] * 7 + [_F, _P],
    # K
    "gx_edge_block_staging_width": [_I],
    # q k v out BHq Hq Hkv S D dtype causal scale stream
    "gx_flash_attention": [_P] * 4 + [_I] * 7 + [_F, _P],
    # x dt a b c y state decay gate B NC L H P G N stream
    "gx_ssd_chunk": [_P] * 9 + [_I] * 7 + [_P],
}

_lib = None
#: Seconds the last build took in this process (0.0 when loaded from disk).
build_seconds = 0.0


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH or
    under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit (PATH or CUDA_HOME)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    """Compiles every source in parallel into a directory of this process's
    own, so that processes building at once never share an object file,
    then links and moves the library into place."""
    nvcc = cuda_tool()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        log = open(work / f"{src.stem}.log", "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
             str(work / f"{src.stem}.o")],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, log, proc in procs:
        if proc.wait() != 0:
            failed.append(src)
        log.close()
    if failed:
        logs = "\n".join((work / f"{s.stem}.log").read_text() for s in failed)
        raise RuntimeError(f"nvcc failed for {[s.name for s in failed]}:\n"
                           f"{logs}")
    lib = work / out.name
    subprocess.run([nvcc, "-shared", "-o", str(lib),
                    *(str(work / f"{s.stem}.o") for s in _sources())],
                   check=True, capture_output=True)
    for src in _sources():
        os.replace(work / f"{src.stem}.log", BUILD_DIR / f"{src.stem}.log")
    os.replace(lib, out)
    shutil.rmtree(work, ignore_errors=True)


def ptxas_report() -> str:
    """The ``-Xptxas -v`` output (registers, shared memory, spills) of the
    last build in this checkout, one section per source."""
    return "\n".join(f"== {p.name}\n{p.read_text()}"
                     for p in sorted(BUILD_DIR.glob("*.log")))


def library_path() -> Path:
    """Where the library of these sources and flags lives once built."""
    return BUILD_DIR / f"libgxplug_{_digest()}.so"


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        t0 = time.perf_counter()
        _build(out)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raises if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
