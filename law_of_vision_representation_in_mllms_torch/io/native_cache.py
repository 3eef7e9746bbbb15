"""Threaded feature reads and packed feature caches (counterpart of the JAX
package's `io/native_cache.py`), through `ctypes` over the repository's C++
library `native/lvr_loader.cpp`.

- `batch_load(paths, item_shape, dtype)`: N same-shape `.npy` files read by
  a pool of threads straight into one [N, *item_shape] array;
- `pack(paths, item_shape, out_path)`: one contiguous `.lvrpack` file: the
  8-byte magic 0x4c56525041434b31 ("LVRPACK1"), the item count and the item
  bytes (little-endian u64 each), then the items. The JAX package writes and
  reads the same layout, so a pack of either package reads in the other;
- `PackedCache(path, item_shape).gather(indices)`: batched random-access
  reads out of a pack, which the library maps into memory.

The library is compiled by `g++` with `native/Makefile`'s flags into
`build/torch_native/` at the repository root on first use; its file name
carries a hash of the source and the flags, as `ops/_build.py` names the
kernel library, so a stale build is never loaded. Nothing is written into
`native/`. A failed build raises with the compiler's output: the port has no
silent fallback. `numpy_batch_load` and `numpy_gather` are the plain readers
the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "lvr_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", "-Wall")
MAGIC = 0x4c56525041434b31
HEADER_BYTES = 24

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_PATHS = ctypes.POINTER(ctypes.c_char_p)
_SIGNATURES = {
    "lvr_batch_load": (_I, (_PATHS, _I, _P, _I64, _I)),
    "lvr_pack": (_I, (_PATHS, _I, _I64, ctypes.c_char_p, _I)),
    "lvr_pack_open": (_P, (ctypes.c_char_p,)),
    "lvr_pack_count": (_I64, (_P,)),
    "lvr_pack_item_bytes": (_I64, (_P,)),
    "lvr_pack_gather": (_I, (_P, ctypes.POINTER(_I64), _I, _P)),
    "lvr_pack_close": (None, (_P,)),
}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"{cxx} not found (set CXX): the native loader "
                           f"is compiled from {SOURCE.name} at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblvr_loader_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/lvr_loader.cpp into the hashed library unless it
    exists. Raises RuntimeError with the compiler's output on failure."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = [_cxx(), *CXX_FLAGS, "-o", lib, str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native loader build failed "
                               f"({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(lib, out)        # atomic: a reader never sees half a file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded loader library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib


def native_available() -> bool:
    """Builds and loads the library; whether that worked."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _c_paths(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def batch_load(paths: Sequence[str], item_shape: Tuple[int, ...],
               dtype=np.float32, n_threads: int = 8) -> np.ndarray:
    """N same-shape .npy files (C order, of `dtype`) into one [N,
    *item_shape] array, read by `n_threads` threads."""
    out = np.empty((len(paths), *item_shape), dtype)
    if not len(paths):
        return out
    fails = library().lvr_batch_load(
        _c_paths(paths), len(paths), out.ctypes.data_as(_P),
        out[0].nbytes, n_threads)
    if fails:
        raise IOError(f"native batch_load: {fails} of {len(paths)} files "
                      f"failed")
    return out


def numpy_batch_load(paths: Sequence[str], item_shape: Tuple[int, ...],
                     dtype=np.float32) -> np.ndarray:
    """`batch_load`'s plain version: one `np.load` a file."""
    out = np.empty((len(paths), *item_shape), dtype)
    for i, p in enumerate(paths):
        out[i] = np.load(p)
    return out


def pack(paths: Sequence[str], item_shape: Tuple[int, ...], out_path: str,
         dtype=np.float32, n_threads: int = 8) -> None:
    """Pack N same-shape .npy files into one `.lvrpack` file."""
    item_bytes = int(np.prod(item_shape)) * np.dtype(dtype).itemsize
    fails = library().lvr_pack(_c_paths(paths), len(paths), item_bytes,
                               os.fsencode(out_path), n_threads)
    if fails:
        raise IOError(f"native pack: {fails} files failed")


def numpy_gather(path: str, indices: Sequence[int],
                 item_shape: Tuple[int, ...], dtype=np.float32
                 ) -> np.ndarray:
    """`PackedCache.gather`'s plain version: the items read from the file's
    header and offsets by numpy."""
    mm = np.memmap(path, np.uint8, "r")
    magic, count, item_bytes = np.frombuffer(mm[:HEADER_BYTES].tobytes(),
                                             "<u8")
    if magic != MAGIC:
        raise IOError(f"{path} is not an .lvrpack file")
    out = np.empty((len(indices), *item_shape), dtype)
    for i, j in enumerate(indices):
        if not 0 <= j < count:
            raise IndexError(f"item {j} of a pack of {count}")
        start = HEADER_BYTES + int(j) * int(item_bytes)
        out[i] = np.frombuffer(mm[start:start + int(item_bytes)].tobytes(),
                               dtype).reshape(item_shape)
    return out


class PackedCache:
    """Batched random-access reads from a `.lvrpack` file."""

    def __init__(self, path: str, item_shape: Tuple[int, ...],
                 dtype=np.float32):
        self.item_shape = tuple(item_shape)
        self.dtype = np.dtype(dtype)
        self._lib = library()
        self._h = self._lib.lvr_pack_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"cannot open pack {path}")
        self.count = int(self._lib.lvr_pack_count(self._h))
        item_bytes = int(self._lib.lvr_pack_item_bytes(self._h))
        want = int(np.prod(self.item_shape)) * self.dtype.itemsize
        if item_bytes != want:
            self.close()
            raise ValueError(f"{path} holds items of {item_bytes} bytes, not "
                             f"{self.item_shape} of {self.dtype} ({want})")

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        out = np.empty((len(indices), *self.item_shape), self.dtype)
        idx = (_I64 * len(indices))(*indices)
        if self._lib.lvr_pack_gather(self._h, idx, len(indices),
                                     out.ctypes.data_as(_P)):
            raise IOError(f"pack gather failed for {list(indices)} of "
                          f"{self.count} items")
        return out

    def close(self):
        if self._h:
            self._lib.lvr_pack_close(self._h)
            self._h = None
