"""Zstandard frames and CRC-32C for the orbax reader (`io/ocdbt.py`,
`io/orbax_state.py`). No zstd Python package is imported: the frames are
decoded by the system's zstd library (`libzstd.so.1`, which the Linux
distributions ship as a dependency of their package managers), bound with
ctypes through its stable API. Where it is missing, `library()` raises and
there is no fallback.

The CRC-32C (Castagnoli) of the OCDBT envelopes is a table-driven loop here:
it covers the manifest and the B-tree nodes only, kilobytes per checkpoint,
never the data files.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

_P = ctypes.c_void_p
_SIZE = ctypes.c_size_t
SONAME = "libzstd.so.1"
CONTENTSIZE_UNKNOWN = (1 << 64) - 1     # ZSTD_CONTENTSIZE_UNKNOWN
CONTENTSIZE_ERROR = (1 << 64) - 2       # ZSTD_CONTENTSIZE_ERROR
DST_TOO_SMALL = 70                      # ZSTD_error_dstSize_tooSmall


@functools.cache
def library() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(SONAME)
    except OSError as e:
        raise OSError(f"the orbax reader decodes zstd frames with the "
                      f"system's {SONAME}, which could not be loaded: "
                      f"{e}") from e
    for name, restype, argtypes in (
            ("ZSTD_decompress", _SIZE, (_P, _SIZE, _P, _SIZE)),
            ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, (_P, _SIZE)),
            ("ZSTD_findFrameCompressedSize", _SIZE, (_P, _SIZE)),
            ("ZSTD_isError", ctypes.c_uint, (_SIZE,)),
            ("ZSTD_getErrorCode", ctypes.c_int, (_SIZE,)),
            ("ZSTD_getErrorName", ctypes.c_char_p, (_SIZE,))):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, list(argtypes)
    return lib


def _buffer(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


def _check(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def content_size(data) -> Optional[int]:
    """The summed content sizes the frames in `data` declare (None where a
    frame does not)."""
    lib, src = library(), _buffer(data)
    total, at = 0, 0
    while at < src.size:
        ptr, rest = src[at:].ctypes.data_as(_P), src.size - at
        n = lib.ZSTD_getFrameContentSize(ptr, rest)
        if n == CONTENTSIZE_ERROR:
            raise ValueError(f"zstd: no frame at byte {at}")
        if n == CONTENTSIZE_UNKNOWN:
            return None
        total += n
        at += _check(lib, lib.ZSTD_findFrameCompressedSize(ptr, rest))
    return total


def decompress(data, size: Optional[int] = None) -> np.ndarray:
    """The frames of `data` (bytes, memoryview or a uint8 array) decoded
    into a new uint8 array. `size`: the decoded size, where the caller knows
    it (a zarr chunk's), else the sizes the frame headers declare, else
    (frames that declare none) a buffer grown until the frames fit. A size
    mismatch raises, as does any malformed frame or content checksum."""
    lib, src = library(), _buffer(data)
    want = content_size(src) if size is None else size
    cap = max(1 << 16, 8 * src.size) if want is None else want
    while True:
        out = np.empty(cap, np.uint8)
        got = lib.ZSTD_decompress(out.ctypes.data_as(_P), cap,
                                  src.ctypes.data_as(_P), src.size)
        if (want is None and lib.ZSTD_isError(got)
                and lib.ZSTD_getErrorCode(got) == DST_TOO_SMALL):
            cap *= 4
            continue
        _check(lib, got)
        if want is not None and got != want:
            raise ValueError(f"zstd: decoded {got} bytes, expected {want}")
        return out[:got]


def _crc_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data) -> int:
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
