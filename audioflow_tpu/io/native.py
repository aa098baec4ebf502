"""ctypes binding to the C++ WAV batch decoder (native/wavcodec.cpp).

Runs ``make`` on first use, which builds the shared library when it is
missing or older than its sources; without a toolchain it falls back cleanly
(callers check :func:`available`). The numpy codec in
:mod:`audioflow_tpu.io.wav` is the behavioral oracle — both are tested for
bit-identical output.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_LIB_PATH = _HERE / "_libwavcodec.so"
_NATIVE_DIR = _HERE.parent.parent / "native"

_lib = None
_load_error: str | None = None


def _build() -> bool:
    if not (_NATIVE_DIR / "Makefile").exists():
        return False
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _LIB_PATH.exists()
    except (subprocess.SubprocessError, OSError):
        return False


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    # make rebuilds a library older than its sources and does nothing when
    # it is fresh, so the loaded code always matches the committed sources
    if not _build():
        _load_error = "building libwavcodec.so failed"
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:  # pragma: no cover
        _load_error = str(e)
        return None
    lib.afw_probe.restype = ctypes.c_int
    lib.afw_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.afw_decode_batch_mono.restype = ctypes.c_int
    lib.afw_decode_batch_mono.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def decode_batch_mono(
    buffers: list[bytes], stride: int, n_threads: int = 0, out: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode WAV byte buffers to a zero-padded mono f32 batch.

    Returns (out [n, stride] f32, n_frames [n] i64 (-1 = failed lane),
    rates [n] i32). Failed lanes are zeroed, never raising — per-lane fault
    isolation (SURVEY §5.3).

    ``out``, if given, is the destination buffer (``[n, stride]`` f32,
    C-contiguous) and is returned; the C++ side zeroes every lane before
    writing, so no host-side clear is needed. Reusing a warm buffer across
    batches avoids the cold mmap of a fresh 41 MB allocation, whose decode
    loop pays one page fault per written page.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_load_error}")
    n = len(buffers)
    if out is None:
        out = np.empty((n, stride), dtype=np.float32)  # C++ memsets each lane
    elif (
        out.shape != (n, stride)
        or out.dtype != np.float32
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(
            f"out must be C-contiguous f32 [{n}, {stride}], got "
            f"{out.dtype} {out.shape}"
        )
    frames = np.zeros(n, dtype=np.int64)
    rates = np.zeros(n, dtype=np.int32)
    buf_ptrs = (ctypes.c_char_p * n)(*buffers)
    lens = (ctypes.c_int64 * n)(*[len(b) for b in buffers])
    lib.afw_decode_batch_mono(
        buf_ptrs,
        lens,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stride,
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    return out, frames, rates
