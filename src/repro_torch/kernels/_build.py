"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, into ``build/kernels/`` at the root of the
checkout, under a name keyed by the content of the sources and their
shared headers (``csrc/*.cuh``), so an edit rebuilds
and an unchanged tree reuses the library.  ``-Xptxas -v`` reports each
kernel's registers, shared memory and spills; :func:`build` returns that
log.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card has no ``nvcc``.

Each wrapper that launches a kernel adds one to that kernel's entry of
:data:`LAUNCHES` (and nowhere else), so a run can show which kernels it
went through.  A kernel's bf16 arm is its own entry point (``_bf16``
appended) and counts under its own name (``/bf16`` appended).  An entry
point that picks one of several bodies per launch (the products' bf16 arm:
``wgmma`` or ``mma.sync``) reports which, and the launch also counts under
``"<name> <body>"`` in :data:`BODIES`.
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
#: ``"<kernel name> <body>"`` -> launches so far, for the kernels whose
#: entry point picks one of several bodies per launch (BODY_NAMES); each
#: such launch also counts under its name in LAUNCHES.
BODIES: collections.Counter = collections.Counter()

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "rolling_mm_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL,
                       _LL, _P],
    "rolling_mm_dx": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL,
                      _LL, _P],
    "rolling_mm_tile": [_I] * 7,
    "sgd_inplace": [_P, _P, _F, _LL, _P],
    "masked_sgd_inplace": [_P, _P, _P, _F, _LL, _P],
    "fillin_agg_inplace": [_P, _P, _P, _F, _LL, _I, _LL, _P],
    "flash_attn_fwd": [_P] * 4 + [_LL] * 12 + [_I] * 8 + [_F, _P],
    "ssd_chunk_intra_fwd": [_P] * 7 + [_LL] * 14 + [_I] * 8 + [_P],
}

# the bf16 arms take the f32 arms' arguments; the products' bf16 arms
# also whether every offset is a multiple of 8 elements, and an int* that
# says which of their bodies ran (BODIES)
_SIGNATURES.update({f"{n}_bf16": _SIGNATURES[n] for n in (
    "sgd_inplace", "masked_sgd_inplace", "fillin_agg_inplace",
    "flash_attn_fwd", "ssd_chunk_intra_fwd")})
_SIGNATURES.update({f"{n}_bf16": _SIGNATURES[n] + [_I, _P] for n in (
    "rolling_mm_fwd", "rolling_mm_dx")})

#: the bodies of a kernel with more than one, by the code its entry point
#: reports: the bf16 products run on wgmma fed by TMA where the tensor map
#: takes their operands, else on mma.sync fed by copies
BODY_NAMES = {"rolling_mm_fwd_bf16": ("mma.sync", "wgmma"),
              "rolling_mm_dx_bf16": ("mma.sync", "wgmma")}

_lib = None


def reset_launches():
    LAUNCHES.clear()
    BODIES.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "the machine with the card (CUDA toolkit needed)")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*(CSRC / s for s in SOURCES), *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
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


#: the operand dtypes the kernels take (``str`` of the torch dtype): the
#: suffix of the arm's entry point, and of its launch-count name
ARMS = {"torch.float32": ("", ""), "torch.bfloat16": ("_bf16", "/bf16")}


def make_current(device: torch.device):
    """Make ``device`` the calling thread's current card.  The autograd
    engine runs a backward on a worker thread of its own, and until a
    PyTorch CUDA call there sets a device, no context is current in it: a
    launch of the kernels' library (its own CUDA runtime) made first in
    such a thread fails with ``cudaErrorInvalidValue`` (seen on an H100:
    rows 6 and 8's bf16 dx as a backward's first CUDA work)."""
    import torch
    torch.cuda.set_device(device)


def launch(entry: str, name: str, dtype, *args):
    """Call the ``dtype`` arm of ``entry`` with ``args`` and count the
    launch under ``name`` (``name/bf16`` for a bf16 one), and, for an arm
    with several bodies, under ``"<that name> <body>"`` in BODIES."""
    fn_suffix, name_suffix = ARMS[str(dtype)]
    bodies = BODY_NAMES.get(entry + fn_suffix)
    body = ctypes.c_int(-1)
    extra = (ctypes.byref(body),) if bodies else ()
    check_launch(name + name_suffix,
                 getattr(library(), entry + fn_suffix)(*args, *extra))
    if bodies:
        BODIES[f"{name}{name_suffix} {bodies[body.value]}"] += 1


def check_launch(name: str, err: int):
    """Raise on a launch error (a refused launch never runs, and a later
    synchronize would not report it); count the launch otherwise."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError "
                           f"{err}")
    LAUNCHES[name] += 1
