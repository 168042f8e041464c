"""Build ``csrc/*.cu`` with nvcc into one shared library and load it.

The sources have a plain C interface (pointers and the stream as
``void*``, sizes as ``int``, a ``cudaError_t`` returned as ``int``), so
they compile in seconds without PyTorch's headers and bind with ``ctypes``.
The build runs at first use into ``port/build/<hash>/``, keyed by a hash
of the sources, their headers and the flags: each ``.cu`` compiles in its
own nvcc process, all started together, then one link.  ``ptxas_log()``
returns the ``-Xptxas -v`` register, shared-memory and spill report of
that build.
``load_variant`` builds other sources or flags the same way into a library
of their own, so a measurement can hold two versions of a kernel side by
side; the port itself only calls ``load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "load_variant", "ptxas_log", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
LIB_NAME = "libbourbon_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (pointers and the stream last as void*)
SIGNATURES = {
    "plr_lookup_rows": [_P] * 8 + [_I, _I, _P],
    "bounded_search_rows": [_P] * 7 + [_I, _I, _I, _P],
    "bloom_probe_rows": [_P] * 5 + [_I, _I, _I, _P],
    "sstable_search_rows": [_P] * 8 + [_I, _I, _I, _I, _P],
    "bloom_probe_stack": [_P] * 4 + [_I, _I, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None
_log = ""


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under $CUDA_HOME)")
    return cand


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path], flags: tuple[str, ...]) -> str:
    """Hash of the flags, the sources and the headers (``*.cuh``) beside
    them, which the sources may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    headers = sorted({hd for src in sources for hd in src.parent.glob("*.cuh")})
    for src in sources + headers:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, sources: list[Path],
             flags: tuple[str, ...]) -> None:
    """Compile every source in parallel, link, and move the library and
    the compilers' reports into ``out_dir`` atomically (a concurrent
    build of the same hash wins or loses the rename harmlessly)."""
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = tmp / LIB_NAME
        link = subprocess.run([nvcc, "-shared", "-o", str(lib),
                               *[str(o) for _, o, _ in procs]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "ptxas.log").write_text(log)
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _build(sources: list[Path],
           flags: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) the library of ``sources``, bind the entry points
    of ``SIGNATURES`` it defines, and return it with its ptxas report."""
    out_dir = BUILD_ROOT / _digest(sources, flags)
    if not (out_dir / LIB_NAME).exists():
        _compile(out_dir, sources, flags)
    lib = ctypes.CDLL(str(out_dir / LIB_NAME))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib, (out_dir / "ptxas.log").read_text()


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and cached per process."""
    global _lib, _log
    if _lib is None:
        lib, log = _build(_sources())
        missing = [n for n in SIGNATURES if not hasattr(lib, n)]
        if missing:
            raise RuntimeError(f"kernel library lacks {missing}")
        _lib, _log = lib, log
    return _lib


def load_variant(sources: list[Path],
                 flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """A separate library of ``sources`` built with ``flags`` added (for
    example ``-DBOUNDED_SEARCH_GROUP=8``), binding whichever entry points
    of ``SIGNATURES`` it defines."""
    return _build(sorted(Path(s).resolve() for s in sources), tuple(flags))[0]


def ptxas_log() -> str:
    """The ``-Xptxas -v`` report of the loaded build ('' before ``load``)."""
    return _log
