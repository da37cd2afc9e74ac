"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

The sources have a plain ``extern "C"`` interface and include no PyTorch
header, so ``nvcc`` compiles them in seconds.  ``library()`` builds at first
use, from the sources of this package and nothing else, into ``build/`` next
to this file (git-ignored; override with ``REPRO_TORCH_BUILD_DIR``): one
``nvcc`` per ``.cu`` source, all started together, then one link into a
shared library.  The library's file name carries a hash of the sources and
of the compiler flags, so a library built from other sources is never
loaded.

Nothing here runs at import time: a machine without ``nvcc`` imports every
module of the package and only fails — loudly, never by falling back — when a
kernel is asked to launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of every exported function: c_void_p for each pointer and the
# stream (else ctypes would pass a 32-bit int and cut the pointer)
SIGNATURES = {
    # ell colors forb0 mex ovf | R W n C lanes window design | stream
    "coloring_firstfit": [_P] * 5 + [_I] * 7 + [_P],
    # ell colors pri U forb0 extra_defect force valid row_ids newc recolored
    # ovf | R W n C row_start lanes window design slot_rows | stream
    "coloring_detect_recolor": [_P] * 12 + [_I] * 9 + [_P],
    # ell_rows ell_all colors pri U force valid row_ids newc recolored ovf |
    # R W n n_all C row_start detect lanes window design | stream
    "coloring_twohop_detect_recolor": [_P] * 11 + [_I] * 10 + [_P],
    # q k v out | B Hq Hkv Lq Lk D causal dtype design | (batch, head, row)
    # strides of q, k, v | scale | stream
    "attn_flash_forward": [_P] * 4 + [_I] * 9 + [ctypes.c_longlong] * 9
                          + [ctypes.c_float, _P],
    # hops design lanes W out(int64[3]) -> threads a block, dynamic shared
    # memory a block, resident groups of the staged pass
    "coloring_staged_shape": [_I] * 4 + [_P],
    # lanes W -> 1 where the two-hop staged designs hold the shape, else 0
    "coloring_twohop_staged_fits": [_I] * 2,
    # D -> dynamic shared memory of the sm90 attention kernel
    "attn_flash_sm90_smem": [_I],
    # ell feats out | R W n d op dtype lanes vec | stream
    "ell_spmm": [_P] * 3 + [_I] * 8 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # None: not built by this process
build_log: str = ""                     # nvcc's output (ptxas -v resources)
compile_seconds: dict = {}              # source file -> its nvcc -c seconds


def build_dir() -> str:
    return os.environ.get("REPRO_TORCH_BUILD_DIR",
                          os.path.join(_HERE, "build"))


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, CUDA_PATH, /usr/local/cuda): the "
        "CUDA kernels of repro_torch.kernels cannot be built here")


def _csrc(suffixes) -> list[str]:
    return [os.path.join(CSRC_DIR, f) for f in sorted(os.listdir(CSRC_DIR))
            if f.endswith(suffixes)]


def source_hash() -> str:
    """Hash of every source and header under ``csrc/`` and of the flags."""
    h = hashlib.sha256()
    for path in _csrc((".cu", ".cuh", ".h")):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(build_dir(), f"libcoloring-{source_hash()}.so")


def _run_all(cmds: list[list[str]]) -> tuple[str, list[float]]:
    """Run the commands at once; raise on the first that fails, after all
    have ended.  Returns their output, in order, and each one's seconds."""
    def one(c):
        t = time.perf_counter()
        p = subprocess.run(c, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        return p, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=len(cmds)) as ex:
        done = list(ex.map(one, cmds))
    for c, (p, _) in zip(cmds, done):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}): "
                               f"{' '.join(c)}\n{p.stdout}")
    return "".join(p.stdout for p, _ in done), [s for _, s in done]


def build() -> str:
    """Compile ``csrc/*.cu`` into the hashed shared library (if it is not
    there yet) and return its path."""
    global build_seconds, build_log
    out = library_path()
    if os.path.isfile(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    srcs = _csrc(".cu")
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    try:
        log, secs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                              for s, o in zip(srcs, objs)])
        compile_seconds.update(
            (os.path.basename(s), t) for s, t in zip(srcs, secs))
        log += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])[0]
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, out)     # atomic: a concurrent process loads a whole file
    build_seconds = time.perf_counter() - t0
    build_log = log
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib
