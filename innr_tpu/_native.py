"""ctypes loader for the native host runtime (native/innr_host.c).

The native library accelerates the *host* side of the framework — the
data-loader encoders and the streaming TopK merge — while the device owns
scoring. Loading is best-effort: if the shared library is missing and a C
compiler is available it is built once into the package tree; otherwise
every caller falls back to pure Python/NumPy with identical semantics.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_LIB_DIR = pathlib.Path(__file__).parent / "_native_lib"
_LIB_PATH = _LIB_DIR / "libinnr_host.so"
_SRC = pathlib.Path(__file__).parent.parent / "native" / "innr_host.c"

_lib = None


def _try_build() -> bool:
    if not _SRC.exists():
        return False
    try:
        _LIB_DIR.mkdir(exist_ok=True)
        subprocess.run(
            [
                "cc", "-O3", "-std=c99", "-shared", "-fPIC", "-pthread",
                "-o", str(_LIB_PATH), str(_SRC),
            ],
            check=True,
            capture_output=True,
            timeout=60,
        )
        return True
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        # Corrupt/truncated library (e.g. an interrupted build): rebuild
        # in place rather than losing the native runtime forever — the
        # same recovery as the stale-ABI path below (regression pin:
        # tests/test_regression_pins.py::TestStaleAbiRebuildPin).
        lib = None
    if lib is None or lib.innr_native_abi_version() != 3:
        # Stale library from an older revision: rebuild in place (without
        # this, every environment holding a previously built .so would
        # silently lose the entire native runtime forever).
        try:
            _LIB_PATH.unlink()
        except OSError:
            return None
        if not _try_build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        if lib.innr_native_abi_version() != 3:
            # dlopen may hand back the cached stale handle within this
            # process; the rebuilt library is on disk, so the next process
            # (and every one after) gets the native runtime.
            return None

    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64

    lib.innr_topk_insert_batch.argtypes = [
        f32p, u32p, i64, ctypes.c_int32, f32p, u32p, i32p,
    ]
    lib.innr_pack_binary_rows.argtypes = [f32p, i64, i64, ctypes.c_float, u32p]
    lib.innr_pack_ternary.argtypes = [f32p, i64, ctypes.c_float, u32p, u32p]
    lib.innr_quantize_u8_rows.argtypes = [
        f32p, i64, i64, ctypes.c_float, ctypes.c_float, u8p,
    ]
    i32 = ctypes.c_int32
    lib.innr_pack_binary_rows_mt.argtypes = [
        f32p, i64, i64, ctypes.c_float, u32p, i32,
    ]
    lib.innr_pack_ternary_rows_mt.argtypes = [
        f32p, i64, i64, ctypes.c_float, u32p, u32p, i32,
    ]
    lib.innr_quantize_u8_rows_mt.argtypes = [
        f32p, i64, i64, ctypes.c_float, ctypes.c_float, u8p, i32,
    ]
    lib.innr_hamming_scan.argtypes = [u32p, u32p, i64, i64, u32p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.innr_minhash_rows_mt.argtypes = [
        u64p, i64p, i64, ctypes.c_int32, u32p, ctypes.c_int32,
    ]
    lib.innr_hamming_words.restype = ctypes.c_uint64
    lib.innr_hamming_words.argtypes = [u32p, u32p, i64]
    _lib = lib
    return lib


def available() -> bool:
    """True when the native host library is loaded (or buildable)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# -- wrappers (None-returning if unavailable; callers keep Python paths) ----

def topk_insert_batch(dists, ids, k, buf_d, buf_i, count) -> int | None:
    """Stream (ids, dists) into the running (buf_d, buf_i, count) tracker.
    Returns the new count, or None when native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    c = ctypes.c_int32(count)
    lib.innr_topk_insert_batch(
        _ptr(dists, ctypes.c_float),
        _ptr(ids, ctypes.c_uint32),
        dists.size,
        k,
        _ptr(buf_d, ctypes.c_float),
        _ptr(buf_i, ctypes.c_uint32),
        ctypes.byref(c),
    )
    return int(c.value)


def _n_threads(r: int) -> int:
    """Encoder thread count: parallel only when the row count pays for it
    (results are bit-identical at any thread count — rows independent)."""
    if r < 16_384:
        return 1
    import os

    return min(os.cpu_count() or 1, 16)


def pack_binary_rows(rows: np.ndarray, threshold: float) -> np.ndarray | None:
    """Encode (R, D) f32 rows to (R, ceil(D/32)) uint32 words on the host."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    r, d = rows.shape
    out = np.zeros((r, (d + 31) // 32), dtype=np.uint32)
    lib.innr_pack_binary_rows_mt(
        _ptr(rows, ctypes.c_float), r, d, threshold, _ptr(out, ctypes.c_uint32),
        _n_threads(r),
    )
    return out


def pack_ternary_rows(rows: np.ndarray, threshold: float):
    """Encode (R, D) f32 rows into ((R, W) pos, (R, W) neg) bitplanes."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    r, d = rows.shape
    w = (d + 31) // 32
    pos = np.zeros((r, w), dtype=np.uint32)
    neg = np.zeros((r, w), dtype=np.uint32)
    lib.innr_pack_ternary_rows_mt(
        _ptr(rows, ctypes.c_float), r, d, threshold,
        _ptr(pos, ctypes.c_uint32), _ptr(neg, ctypes.c_uint32), _n_threads(r),
    )
    return pos, neg


def pack_ternary(v: np.ndarray, threshold: float):
    """Encode a (D,) f32 vector into (pos, neg) uint32 bitplanes."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(v, dtype=np.float32)
    w = (v.size + 31) // 32
    pos = np.zeros(w, dtype=np.uint32)
    neg = np.zeros(w, dtype=np.uint32)
    lib.innr_pack_ternary(
        _ptr(v, ctypes.c_float), v.size, threshold,
        _ptr(pos, ctypes.c_uint32), _ptr(neg, ctypes.c_uint32),
    )
    return pos, neg


def quantize_u8_rows(rows: np.ndarray, alpha: float, offset: float) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    r, d = rows.shape
    out = np.zeros((r, d), dtype=np.uint8)
    lib.innr_quantize_u8_rows_mt(
        _ptr(rows, ctypes.c_float), r, d, alpha, offset,
        _ptr(out, ctypes.c_uint8), _n_threads(r),
    )
    return out


def hamming_scan(query: np.ndarray, corpus: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    query = np.ascontiguousarray(query, dtype=np.uint32)
    corpus = np.ascontiguousarray(corpus, dtype=np.uint32)
    out = np.zeros(corpus.shape[0], dtype=np.uint32)
    lib.innr_hamming_scan(
        _ptr(query, ctypes.c_uint32), _ptr(corpus, ctypes.c_uint32),
        corpus.shape[0], corpus.shape[1], _ptr(out, ctypes.c_uint32),
    )
    return out


def minhash_rows(items: np.ndarray, offsets: np.ndarray, n_slots: int) -> np.ndarray | None:
    """MinHash-sketch ragged documents: ``items`` is the concatenation of
    all docs' u64 item hashes, ``offsets`` the (n_docs + 1,) int64 prefix.
    Returns (n_docs, n_slots) uint32 sketches, or None when native is
    unavailable. Bit-identical to the NumPy fallback in loader.py."""
    lib = _load()
    if lib is None:
        return None
    items = np.ascontiguousarray(items, dtype=np.uint64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_docs = offsets.size - 1
    out = np.empty((n_docs, int(n_slots)), dtype=np.uint32)
    lib.innr_minhash_rows_mt(
        _ptr(items, ctypes.c_uint64),
        _ptr(offsets, ctypes.c_int64),
        n_docs,
        int(n_slots),
        _ptr(out, ctypes.c_uint32),
        _n_threads(n_docs),
    )
    return out
