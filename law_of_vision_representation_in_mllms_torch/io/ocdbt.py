"""A read-only reader of OCDBT databases, the key-value store under an orbax
checkpoint (the JAX runner's `checkpoint-{step}`, `use_ocdbt: true`), with
no tensorstore import.

Files (every integer little-endian; a varint is LEB128):
- the manifest, `manifest.ocdbt`, and the B-tree nodes, under `d/` (or
  `ocdbt.process_N/d/` for process N of a multi-process save, whose files
  the top manifest's tree refers to by that path). Each file is an
  envelope: a big-endian magic (0x0cdb3a2a manifest, 0x0cdb20de node), the
  file's length (u64), a format version (varint, 0), a compression method
  (varint: 0 none, 1 a zstd frame), the payload, and the CRC-32C of all the
  bytes before it (u32). A node may also sit inside a data file, at an
  offset, as the last node a writer flushed does;
- data files, under the same `d/` directories, which hold the values too
  large to store in a node (plain bytes at an offset; a zarr chunk is a
  zstd frame of its own).

The manifest payload: the config (a 16-byte uuid; the manifest kind,
varint, 0 for a single manifest file; the largest inline value and decoded
node sizes, varints; the version tree's arity log2, a byte; the
compression method, varint, and for zstd its level, an i32), then the
inline versions: a data file table, the version count and one column per
field (generation numbers, root heights as bytes, the root's data file,
offset and length, its key count, tree bytes and indirect value bytes,
commit times as u64), then the count of version tree nodes (older
versions, not read here). The newest version's root is the tree read.

A data file table: the file count, then for each file after the first the
length of the prefix it shares with the one before, each file's suffix
length and base-path length, then the suffixes.

A B-tree node payload: its height (a byte; 0 for a leaf), a data file
table, the entry count, the key prefix lengths (shared with the entry
before), the key suffix lengths, in an interior node each child's common
key prefix length, the key suffixes; then a leaf's value lengths and kinds
(0 inline, 1 in a data file), the data file and offset of each value kept
in a data file, and the inline values back to back; an interior node's
child locations (data file, offset, length) and statistics (keys, tree
bytes, indirect value bytes). A child's keys leave out its common prefix,
which its parent's entry key starts with.

`Database(path).items()` walks the newest version's tree into a {key:
`Value`} dict; `Value.read()` returns the bytes. Every envelope's CRC-32C is
checked; a mismatch raises `CorruptError`.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Optional

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_OFFSET = (1 << 64) - 1     # an empty tree's root location


class CorruptError(ValueError):
    """A file of the database is not what its format says."""


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise CorruptError(f"{self.what}: truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return out

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CorruptError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def _envelope(data: bytes, magic: int, what: str) -> bytes:
    """The payload of a manifest or node file, its checks passed."""
    if len(data) < 16 or struct.unpack(">I", data[:4])[0] != magic:
        raise CorruptError(f"{what}: bad magic")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise CorruptError(f"{what}: length field {data[4:12].hex()} does "
                           f"not match the {len(data)} bytes read")
    if zstd.crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise CorruptError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    if r.varint() != 0:
        raise CorruptError(f"{what}: unknown format version")
    method = r.varint()
    body = data[r.pos:-4]
    if method == 0:
        return body
    if method != 1:
        raise CorruptError(f"{what}: unknown compression {method}")
    return zstd.decompress(body).tobytes()


def _file_table(r: _Reader) -> List[str]:
    n = r.varint()
    shared = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    r.varints(n)                              # base path lengths
    paths, prev = [], b""
    for i in range(n):
        path = (prev[:shared[i - 1]] if i else b"") + r.take(suffix[i])
        paths.append(path.decode())
        prev = path
    return paths


@dataclasses.dataclass(frozen=True)
class Location:
    path: str              # relative to the database root
    offset: int
    length: int


@dataclasses.dataclass(frozen=True)
class Value:
    """A value: inline bytes, or a range of a data file."""
    db: "Database"
    inline: Optional[bytes] = None
    at: Optional[Location] = None

    def read(self) -> bytes:
        return self.inline if self.at is None else self.db.read(self.at)


class Database:
    """The OCDBT database rooted at `path` (the directory holding
    `manifest.ocdbt`)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "manifest.ocdbt"), "rb") as f:
            data = f.read()
        r = _Reader(_envelope(data, MANIFEST_MAGIC, "manifest.ocdbt"),
                    "manifest.ocdbt")
        r.take(16)                                    # uuid
        kind = r.varint()
        if kind != 0:
            raise CorruptError("numbered manifests are not read (orbax "
                               "writes a single manifest file)")
        r.varint()                                    # max inline bytes
        r.varint()                                    # max decoded node bytes
        r.byte()                                      # version tree arity
        if r.varint() == 1:
            r.take(4)                                 # zstd level (i32)
        files = _file_table(r)
        n = r.varint()
        generation = r.varints(n)
        height = list(r.take(n))
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        if not n:
            raise CorruptError("manifest.ocdbt: no version")
        newest = max(range(n), key=generation.__getitem__)
        self.generation = generation[newest]
        self.root = None if offset[newest] == NO_OFFSET else Location(
            files[file_id[newest]], offset[newest], length[newest])
        self.root_height = height[newest]

    def read(self, at: Location) -> bytes:
        with open(os.path.join(self.path, at.path), "rb") as f:
            f.seek(at.offset)
            data = f.read(at.length)
        if len(data) != at.length:
            raise CorruptError(f"{at.path}: {len(data)} bytes at "
                               f"{at.offset}, expected {at.length}")
        return data

    def _node(self, at: Location, prefix: bytes,
              out: Dict[bytes, Value]) -> None:
        what = f"{at.path}@{at.offset}"
        r = _Reader(_envelope(self.read(at), NODE_MAGIC, what), what)
        height = r.byte()
        files = _file_table(r)
        n = r.varint()
        shared = r.varints(max(n - 1, 0))
        suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            key = (prev[:shared[i - 1]] if i else b"") + r.take(suffix[i])
            keys.append(key)
            prev = key
        if height:
            file_id, offset, length = r.varints(n), r.varints(n), \
                r.varints(n)
            for i in range(n):
                self._node(Location(files[file_id[i]], offset[i], length[i]),
                           prefix + keys[i][:common[i]], out)
            return
        size = r.varints(n)
        kind = r.varints(n)
        far = [i for i in range(n) if kind[i] == 1]
        if any(k not in (0, 1) for k in kind):
            raise CorruptError(f"{what}: unknown value kind")
        file_id, offset = r.varints(len(far)), r.varints(len(far))
        refs = {i: Location(files[f], o, size[i])
                for i, f, o in zip(far, file_id, offset)}
        for i in range(n):
            out[prefix + keys[i]] = (Value(self, at=refs[i]) if i in refs
                                     else Value(self, inline=r.take(size[i])))

    def items(self) -> Dict[bytes, Value]:
        """Every key of the newest version and its value."""
        out: Dict[bytes, Value] = {}
        if self.root is not None:
            self._node(self.root, b"", out)
        return out
