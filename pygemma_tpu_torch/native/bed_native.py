"""ctypes binding of the host readers in ``bed_reader.cpp``: the .bed
decoder and the filtered ASCII matrix reader.

The shared library is built at first use with ``g++ -O3`` into the
package's ``_build/`` directory (listed in .gitignore), named by a hash of
the source and flags, so a changed source is rebuilt and a stale library is
never loaded.  There is no silent fallback: a failed build raises with the
compiler's output, and the NumPy decoder in :mod:`pygemma_tpu_torch.io.plink`
runs only when the caller asks for it (``read_bed(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "bed_reader.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile ``bed_reader.cpp`` (once per source content and flags) and
    return the shared library's path; raises with g++'s stderr if the
    build fails."""
    tag = hashlib.blake2b(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode(),
                          digest_size=8).hexdigest()
    lib_path = BUILD_DIR / f"libbed_reader_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} with g++ failed: {e}") \
            from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pygemma_decode_bed.restype = ctypes.c_int
            lib.pygemma_decode_bed.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.pygemma_read_filtered_matrix.restype = ctypes.c_int
            lib.pygemma_read_filtered_matrix.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p,
            ]
            _lib = lib
        return _lib


def decode_bed(path: str, n: int, bytes_per_snp: int, snp_idx: np.ndarray,
               count_a1: bool, n_threads: int = 0) -> np.ndarray:
    """Decode the .bed columns ``snp_idx`` -> (n, len(snp_idx)) float32
    dosages, NaN for missing.  The caller checks ``snp_idx`` against the
    file's SNP count."""
    if n < 0 or bytes_per_snp != (n + 3) // 4:
        raise ValueError(f"bytes_per_snp {bytes_per_snp} does not fit n={n}")
    lib = _load()
    snp_idx = np.ascontiguousarray(snp_idx, dtype=np.int64)
    out = np.empty((n, len(snp_idx)), dtype=np.float32)
    rc = lib.pygemma_decode_bed(
        os.fsencode(path), n, bytes_per_snp, snp_idx.ctypes.data,
        len(snp_idx), int(count_a1), n_threads, out.ctypes.data)
    if rc != 0:
        raise OSError(f"native .bed decode failed (rc={rc}) for {path}")
    return out


def available() -> bool:
    """Whether the library builds and loads here.  Nothing falls back on
    the answer: the readers raise when it is False."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def read_filtered_matrix(path: str, indices) -> np.ndarray:
    """The (k, k) float32 submatrix of a whitespace-separated ASCII matrix
    file at the rows and columns ``indices`` (sorted here), streamed one line
    at a time: the reference's matrix_reader
    (experiments/benchmarks/matrix_reader.cpp)."""
    indices = np.sort(np.asarray(indices, dtype=np.int64).reshape(-1))
    if len(indices) and (indices[0] < 0
                         or (np.diff(indices) == 0).any()):
        raise ValueError("indices must be distinct and non-negative")
    lib = _load()
    idx = np.ascontiguousarray(indices)
    out = np.empty((len(idx), len(idx)), dtype=np.float32)
    rc = lib.pygemma_read_filtered_matrix(os.fsencode(path), idx.ctypes.data,
                                          len(idx), out.ctypes.data)
    if rc != 0:
        raise OSError(f"native filtered matrix read failed (rc={rc}) for "
                      f"{path}")
    return out
