"""On-disk format primitives shared by the storage engine.

Every durable structure is built from two primitives:

* **frames** — `[u32 length][u32 crc32][payload]` records appended to a
  log file (WAL, MANIFEST).  Readers stop cleanly at a torn tail: a short
  read or crc mismatch ends replay without error, which is exactly the
  crash-consistency contract (anything past the last complete frame was
  never acknowledged).
* **sections** — raw little-endian numpy arrays at 8-byte-aligned offsets
  inside a fixed-layout file (SSTable, value-log segment), so loading is
  ``np.frombuffer`` over an ``mmap`` — zero-copy back into the int64/u64
  arrays the :class:`LookupEngine` stacks onto device.

File naming lives here too so every module agrees on it.
"""

from __future__ import annotations

import os
import struct
import zlib

__all__ = [
    "MAGIC_SST", "MAGIC_MODEL", "MAGIC_FILTER", "crc32", "write_frame",
    "read_frames", "valid_frames_end", "fsync_dir", "sst_path", "wal_path",
    "vlog_path", "lmodel_path", "filter_path", "manifest_name", "CURRENT",
    "FRAME_HDR_SIZE",
]

MAGIC_SST = b"BRBNSST1"
MAGIC_MODEL = b"BRBNPLR1"
MAGIC_FILTER = b"BRBNFLT1"
CURRENT = "CURRENT"

_FRAME_HDR = struct.Struct("<II")
FRAME_HDR_SIZE = _FRAME_HDR.size


def crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def fsync_dir(dirpath: str) -> None:
    """fsync a directory so created/renamed entries survive power loss
    (the LevelDB/SQLite pattern; no-op value for OS-crash-only safety)."""
    fd = os.open(dirpath, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_frame(f, payload: bytes) -> None:
    f.write(_FRAME_HDR.pack(len(payload), crc32(payload)))
    f.write(payload)


def read_frames(path: str):
    """Yield complete frame payloads; stop silently at a torn tail."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + _FRAME_HDR.size <= len(data):
        length, crc = _FRAME_HDR.unpack_from(data, off)
        body_off = off + _FRAME_HDR.size
        if body_off + length > len(data):
            return  # torn tail: incomplete payload
        payload = data[body_off: body_off + length]
        if crc32(payload) != crc:
            return  # torn tail: bad checksum
        yield payload
        off = body_off + length


def valid_frames_end(path: str) -> int:
    """Byte offset just past the last valid frame.  A writer reopening a
    frame log for append MUST truncate to this first — appending after a
    torn frame would make every later frame invisible to replay."""
    return sum(_FRAME_HDR.size + len(p) for p in read_frames(path))


def sst_path(dirpath: str, file_id: int) -> str:
    return os.path.join(dirpath, f"{file_id:06d}.sst")


def wal_path(dirpath: str, wal_no: int) -> str:
    return os.path.join(dirpath, f"wal-{wal_no:06d}.log")


def vlog_path(dirpath: str, seg: int) -> str:
    return os.path.join(dirpath, f"vlog-{seg:06d}.seg")


def lmodel_path(dirpath: str, level: int, epoch: int) -> str:
    """Sidecar holding a persisted level-granularity PLR model; the
    MANIFEST ``lmodel`` record names the (level, epoch) pair that is live."""
    return os.path.join(dirpath, f"lm-{level}-{epoch:06d}.plm")


def filter_path(dirpath: str, level: int, epoch: int) -> str:
    """Sidecar holding a persisted level bloom filter; the MANIFEST
    ``filter`` record names the (level, epoch) pair that is live."""
    return os.path.join(dirpath, f"flt-{level}-{epoch:06d}.bf")


def manifest_name(no: int) -> str:
    return f"MANIFEST-{no:06d}"
