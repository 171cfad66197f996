"""Build and load the hand-written CUDA kernels of ``gpr_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc`` -- one process per
source, all started together -- and linked into one shared library with a
plain C interface, under ``gpr_tpu_torch/_build/``, loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds, not minutes.  The
library's name carries a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an edit to any of them rebuilds;
a file lock keeps concurrent processes from building the same library twice.

Unlike the CSV parser's binding (``gpr_tpu/io/native.py``), nothing here
degrades: a missing compiler, a failed build or a failed load raises, with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("se_iso_stats.cu", "se_iso_bwd.cu", "gemm_chain.cu")
# csrc/fp32_tile.cuh holds the FP32 product loop of all three sources and
# csrc/stats_tile.cuh what the two statistics kernels share on it; every
# csrc/*.cuh is part of the library's key.
# Plain IEEE f32: no --use_fast_math (the f32 evidence is only as good as the
# Knm / V entries).  -Xptxas -v writes registers and spills to the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_STATS_ARGTYPES = [
    _P, _P, _P, _P, _P,  # X, y, mask (or NULL), z, u_inv
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # n, d, m
    ctypes.c_float, ctypes.c_float, ctypes.c_float,  # q, log_sf2, sigma2
    ctypes.c_int, ctypes.c_int,  # n_ctas, tiles_per_cta
    _P, _P, _P,  # gram_part, sums_part, stream
]
_BWD_ARGTYPES = [
    _P, _P, _P, _P,  # X, y, mask (or NULL), z
    _P, _P, _P, _P,  # u_inv, u_inv_t, Gs (tiled route) or UG (wide), ubar
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # n, d, m
    # q, log_sf2, sigma2, lds_bar, yiy_bar, isr_bar
    *[ctypes.c_float] * 6,
    ctypes.c_int, ctypes.c_int,  # n_ctas, tiles_per_cta
    ctypes.c_int, _P,  # share, turn (or NULL)
    _P, _P, _P, _P, _P,  # ui_part, caug_part, sums_part, y_bar, stream
]
_CHAIN_ARGTYPES = [
    _P, _P, _P,  # x, W, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # n, m, reps
    ctypes.c_int, _P,  # n_ctas, stream
]


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of gpr_tpu_torch are built from source at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256()
    headers = sorted(p.name for p in _CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"libgpr_tpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands side by side; (returncode, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, " ".join(c) + "\n" + o)
            for p, c, o in zip(procs, cmds, outs)]


def _build(out: Path) -> None:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.with_suffix(f".{os.getpid()}.{s}.o") for s in SOURCES]
    nvcc = _nvcc()
    try:
        results = _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
            for s, o in zip(SOURCES, objs)
        ])
        if all(rc == 0 for rc, _ in results):
            results += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o",
                                  str(tmp), *map(str, objs)]])
        log = "".join(text for _, text in results)
        out.with_suffix(".log").write_text(log)
        failed = [rc for rc, _ in results if rc != 0]
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed.  Raises on any
    failure; a failed call is retried by the next one."""
    out = library_path()
    _BUILD.mkdir(exist_ok=True)
    with open(_BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _build(out)
    lib = ctypes.CDLL(str(out))
    for name in ("se_iso_stats_acc", "se_iso_stats_partials"):
        fn = getattr(lib, name)
        fn.argtypes = _STATS_ARGTYPES
        fn.restype = ctypes.c_int
    lib.se_iso_bwd_acc.argtypes = _BWD_ARGTYPES
    lib.se_iso_bwd_acc.restype = ctypes.c_int
    lib.gemm_chain.argtypes = _CHAIN_ARGTYPES
    lib.gemm_chain.restype = ctypes.c_int
    lib.gemm_chain_smem_bytes.argtypes = [ctypes.c_int]
    lib.gemm_chain_smem_bytes.restype = ctypes.c_longlong
    for prefix in ("se_iso_stats", "se_iso_bwd"):
        smem = getattr(lib, f"{prefix}_smem_bytes")
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_longlong
        for what in ("groups", "wide_rows"):
            fn = getattr(lib, f"{prefix}_{what}")
            fn.argtypes = [ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
    lib.se_iso_stats_error_string.argtypes = [ctypes.c_int]
    lib.se_iso_stats_error_string.restype = ctypes.c_char_p
    return lib
