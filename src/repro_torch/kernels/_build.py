"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, into ``build/kernels/`` at the root of the
checkout, under a name keyed by the sources' content, so an edit rebuilds
and an unchanged tree reuses the library.  ``-Xptxas -v`` reports each
kernel's registers, shared memory and spills; :func:`build` returns that
log.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card has no ``nvcc``.

Each wrapper that launches a kernel adds one to that kernel's entry of
:data:`LAUNCHES` (and nowhere else), so a run can show which kernels it
went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("rolling_mm.cu", "sgd.cu", "masked_update.cu", "flash_attn.cu",
           "ssd_chunk.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: Kernel name -> launches so far in this process.
LAUNCHES: collections.Counter = collections.Counter()

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "rolling_mm_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL,
                       _LL, _P],
    "rolling_mm_dx": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL,
                      _LL, _P],
    "rolling_mm_tile": [_I] * 6,
    "sgd_inplace": [_P, _P, _F, _LL, _P],
    "masked_sgd_inplace": [_P, _P, _P, _F, _LL, _P],
    "fillin_agg_inplace": [_P, _P, _P, _F, _LL, _I, _LL, _P],
    "flash_attn_fwd": [_P] * 4 + [_LL] * 12 + [_I] * 8 + [_F, _P],
    "ssd_chunk_intra_fwd": [_P] * 7 + [_LL] * 14 + [_I] * 8 + [_P],
}

_lib = None


def reset_launches():
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "the machine with the card (CUDA toolkit needed)")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update((CSRC / s).read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if this content has not been built; returns
    ``(library path, nvcc log with the -Xptxas -v report)``."""
    out = BUILD_DIR / f"librepro_torch_{_key()}.so"
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        return out, log.read_text()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for s in SOURCES:
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / s),
                   "-o", str(tmp / (Path(s).stem + ".o"))]
            procs.append((s, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        text, failed = [], []
        for s, p in procs:
            stdout, _ = p.communicate()
            text.append(f"== nvcc {s}\n{stdout}")
            if p.returncode:
                failed.append(s)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(text))
        objs = [str(tmp / (Path(s).stem + ".o")) for s in SOURCES]
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                               str(tmp / "lib.so"), *objs],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        log_text = "\n".join(text)
        (tmp / "lib.log").write_text(log_text)
        # rename last: a concurrent process sees either nothing or both
        (tmp / "lib.log").replace(log)
        (tmp / "lib.so").replace(out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, log_text


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(name: str, err: int):
    """Raise on a launch error (a refused launch never runs, and a later
    synchronize would not report it); count the launch otherwise."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError "
                           f"{err}")
    LAUNCHES[name] += 1
