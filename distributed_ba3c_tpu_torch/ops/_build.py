"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``build/kernels/`` at the repo root, then
bound with ``ctypes``. The library's file name carries a digest of the
source, of every header in ``csrc/`` and of the flags, so an edited source
or header is rebuilt and a built one is reused. Nothing is built when a module is imported: :func:`load` builds at
first use, and :func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

#: the C entry points of each source: name -> (restype, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "conv_block": {
        # x, x_uint8, w, b, y, B, H, W, Ci, Co, kh, kw, pool, scale, stream
        "ba3c_conv_block_fwd": (
            _I, [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
        ),
    },
    "conv_block_bwd": {
        # x, x_uint8, w, b, g, dz, dbpart, dbpart_cap, n_dbpart (int*),
        # flax, B, H, W, Ci, Co, kh, kw, pool, scale, stream
        "ba3c_conv_block_route": (
            _I,
            [_P, _I, _P, _P, _P, _P, _P, _I, ctypes.POINTER(_I),
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
        ),
        # dz, w (the forward's HWIO), dx, B, H, W, Ci, Co, kh, kw, pool, stream
        "ba3c_conv_block_dgrad": (
            _I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        ),
        # x, x_uint8, dz, dbpart, n_dbpart, part, part_cap, dw, db,
        # B, H, W, Ci, Co, kh, kw, pool, scale, stream
        "ba3c_conv_block_wgrad": (
            _I,
            [_P, _I, _P, _P, _I, _P, _I, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
        ),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ at first use"
        )
    return found


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built for its current source, the
    headers in ``csrc/`` (any of them may be included) and the flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as fh:
            digest.update(fname.encode() + b"\0" + fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Iterable[str]) -> List[str]:
    """Build every named source that is not built yet, one ``nvcc`` each,
    all started together; returns the library paths. Raises with the
    compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = list(names)
    paths = [library_path(n) for n in names]
    lock_fh = open(os.path.join(BUILD_DIR, ".lock"), "w")
    try:
        # one builder at a time across processes; the others wait and then
        # find the libraries built
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        procs = []
        for name, path in zip(names, paths):
            if os.path.isfile(path):
                continue
            tmp = f"{path}.tmp{os.getpid()}"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for name, path, tmp, proc in procs:
            out, _ = proc.communicate()
            with open(path[:-3] + ".log", "w") as fh:
                fh.write(out)
            if proc.returncode == 0:
                os.replace(tmp, path)
            else:
                failed.append(f"nvcc {name}.cu (rc {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        fcntl.flock(lock_fh, fcntl.LOCK_UN)
        lock_fh.close()
    return paths


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the
    current build of ``name``, or '' when it has not been built."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.isfile(log):
        return ""
    with open(log) as fh:
        return fh.read()


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built at first use, with
    the argument types of its C entry points set."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build_all([name])
            lib = ctypes.CDLL(path)
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
    return lib
