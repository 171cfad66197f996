"""ctypes binding for the native CSV parser (``native/csvload.cc``): the
counterpart of ``gpr_tpu/io/native.py``, with the same entry points and
error messages.

The shared library is built at first use with ``g++ -O3 -shared -fPIC``
into ``gpr_tpu_torch/_build/`` (git-ignored), under a name that carries a
hash of the source, so an edit rebuilds; the build writes a temporary file
and renames it, so concurrent processes never load a half-written library.
Where no toolchain is available, ``parse_csv_bytes`` and ``load_csv_file``
return None and the caller falls back to the Python line reader, as the JAX
package's binding does.  This is host parsing, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "csvload.cc"
_BUILD = _PKG / "_build"

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libcsvload-{digest}.so"


def _build(lib: Path) -> bool:
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        path = _lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        out_args = [ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64)]
        lib.csv_parse_buffer.restype = ctypes.c_int
        lib.csv_parse_buffer.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         *out_args]
        lib.csv_load_file.restype = ctypes.c_int
        lib.csv_load_file.argtypes = [ctypes.c_char_p, *out_args]
        lib.csv_free.restype = None
        lib.csv_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


class CsvError(ValueError):
    def __init__(self, code: int, line: int):
        self.code = code
        self.line = line
        if code == -2 and line == 0:
            msg = "no data"  # bin/ocaml_gpr.ml:153
        else:
            msg = {
                -1: f"incompatible dimension of sample in line {line}",
                -2: f"failure converting sample in line {line}",
                -3: "out of memory or I/O failure",
            }.get(code, f"csv parse error {code}")
        super().__init__(msg)


def _call(entry, *head) -> np.ndarray | None:
    """Run ``entry`` of the library on ``head`` plus the four out-pointers
    and collect its (n, d) array; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_double)()
    rows, cols, err_line = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = getattr(lib, entry)(*head, ctypes.byref(out), ctypes.byref(rows),
                             ctypes.byref(cols), ctypes.byref(err_line))
    if rc != 0:
        raise CsvError(rc, err_line.value)
    try:
        return np.ctypeslib.as_array(out, shape=(rows.value,
                                                 cols.value)).copy()
    finally:
        lib.csv_free(out)


def parse_csv_bytes(data: bytes) -> np.ndarray | None:
    """(n, d) float64 array, or None if the native library is unavailable."""
    return _call("csv_parse_buffer", data, len(data))


def load_csv_file(path: str) -> np.ndarray | None:
    """(n, d) float64 array of the file at ``path``, or None if the native
    library is unavailable."""
    return _call("csv_load_file", str(path).encode())
