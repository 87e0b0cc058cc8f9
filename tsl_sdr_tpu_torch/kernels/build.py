"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and load it.

The kernels have a plain C interface (pointers, ints and the CUDA stream),
so the library builds in seconds without PyTorch's headers and binds with
ctypes. It is built at first use into ``build/tsl_sdr_tpu_torch/`` beside
the package (one ``nvcc`` per source, all started together, then one link),
and rebuilt whenever a hash of the sources, headers and flags changes.
Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but success.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tsl_sdr_tpu_torch"
LIB_NAME = "libtsl_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures: every pointer (and the stream) as c_void_p — ctypes would
# otherwise pass a Python int as a 32-bit int and cut the pointer
SIGNATURES = {
    "tsl_chain_fm": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tsl_chain_fm_bank": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tsl_exact_fir": [_P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tsl_row_resample": [_P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _L, _I, _I, _P],
    "tsl_frame_resample": [_P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _L, _I, _I,
                           _I, _I, _I, _P],
    "tsl_dc_block_exact": [_P, _P, _P, _L, _I, _I, _P],
    "tsl_costas_chunks": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I,
                          _F, _F, _F, _F, _F, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = 0.0   # wall time of the last build (0.0 when up to date)
ptxas_log = ""        # the compiler's per-kernel register/smem report


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on the PATH, else under ``CUDA_HOME``
    (default ``/usr/local/cuda``); the toolkit's other tools sit beside
    it."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # sources and shared headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise on the first that fails.
    Returns their standard error, concatenated."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    logs = []
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _build(lib_path: Path, digest: str) -> None:
    global build_seconds, ptxas_log
    t0 = time.monotonic()
    tag = f"tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    try:
        nvcc = nvcc_path()
        ptxas_log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)]
                              for src, obj in zip(_sources(), objs)])
        tmp = lib_path.with_suffix(f".{tag}.so")
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib_path)
    (BUILD_DIR / f"{LIB_NAME}.sha256").write_text(digest)
    build_seconds = time.monotonic() - t0


def compile_shared(sources, lib_path: Path) -> str:
    """Build CUDA sources outside the kernel library (a measurement probe,
    a patched copy of a kernel) into the shared library ``lib_path`` with
    the library's flags, in one ``nvcc``; they may include ``csrc``'s
    headers. Returns the compiler's register/smem report."""
    Path(lib_path).parent.mkdir(parents=True, exist_ok=True)
    return _run_all([[nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-shared",
                      "-o", str(lib_path), *map(str, sources)]])


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / f"{LIB_NAME}.sha256"
        digest = _digest()
        # one build at a time across processes sharing the checkout
        with open(BUILD_DIR / "build.lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if not (lib_path.exists() and stamp.exists()
                    and stamp.read_text() == digest):
                _build(lib_path, digest)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tsl_error_string.argtypes = [ctypes.c_int]
        lib.tsl_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().tsl_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
