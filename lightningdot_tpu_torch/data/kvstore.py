"""ldkv: mmap'd read-only key-value store (the port's copy of
lightningdot_tpu/data/kvstore.py; the LMDB replacement).

Native C++ read path (the shared ``native/ldkv.cc`` through ctypes, built
by the port's :mod:`lightningdot_tpu_torch.native`) with a pure-python mmap
reader implementing the identical file format. The writer is Python (the
store is write-once at prepro time, read-hot at training time, as the
reference uses LMDB, uniter_model/data/data.py:137-174). Files written by
either package read in the other.
"""
from __future__ import annotations

import ctypes
import mmap
import os
import struct
from typing import Dict, Iterable, Optional, Tuple, Union

from lightningdot_tpu_torch.native import load_native

_MAGIC = b"LDKV0001"
_HEADER = struct.Struct("<8sQQ")          # magic, n, index_offset
_ENTRY = struct.Struct("<QQIIQQ")          # hash, key_off, key_len, pad, val_off, val_len

Bytes = Union[bytes, bytearray, memoryview]


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _load_native() -> Optional[ctypes.CDLL]:
    """Configure the shared native ldkv library; None if unavailable."""
    lib = load_native("ldkv")
    if lib is None:
        return None
    lib.ldkv_open.restype = ctypes.c_void_p
    lib.ldkv_open.argtypes = [ctypes.c_char_p]
    lib.ldkv_close.argtypes = [ctypes.c_void_p]
    lib.ldkv_count.restype = ctypes.c_uint64
    lib.ldkv_count.argtypes = [ctypes.c_void_p]
    lib.ldkv_get.restype = ctypes.c_int
    lib.ldkv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_uint32,
                             ctypes.POINTER(ctypes.c_void_p),
                             ctypes.POINTER(ctypes.c_uint64)]
    lib.ldkv_key_at.restype = ctypes.c_int
    lib.ldkv_key_at.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_uint32)]
    return lib


_native_lib: Optional[ctypes.CDLL] = None
_native_tried = False


def native_lib() -> Optional[ctypes.CDLL]:
    global _native_lib, _native_tried
    if not _native_tried:
        _native_tried = True
        _native_lib = _load_native()
    return _native_lib


class KVWriter:
    """Write-once builder for an ldkv file."""

    def __init__(self, path: str):
        self.path = path
        self._entries: list[Tuple[bytes, int, int]] = []  # key, val_off, len
        self._tmp = open(path + ".tmp", "wb")
        self._off = _HEADER.size
        self._tmp.write(b"\x00" * _HEADER.size)

    def put(self, key: Union[str, bytes], value: Bytes) -> None:
        key_b = key.encode("utf-8") if isinstance(key, str) else bytes(key)
        pad = (-self._off) % 8
        if pad:
            self._tmp.write(b"\x00" * pad)
            self._off += pad
        self._entries.append((key_b, self._off, len(value)))
        self._tmp.write(value)
        self._off += len(value)

    def close(self) -> None:
        index_offset = self._off + ((-self._off) % 8)
        self._tmp.write(b"\x00" * (index_offset - self._off))
        # last-wins dedupe: duplicate puts must read back identically on the
        # native (first-match scan) and python (dict overwrite) readers
        latest: Dict[bytes, Tuple[int, int]] = {}
        for k, off, ln in self._entries:
            latest[k] = (off, ln)
        entries = sorted(
            ((_fnv1a(k), k, off, ln) for k, (off, ln) in latest.items()),
            key=lambda e: (e[0], e[1]))
        key_blob = bytearray()
        packed = bytearray()
        for h, k, off, ln in entries:
            packed += _ENTRY.pack(h, len(key_blob), len(k), 0, off, ln)
            key_blob += k
        self._tmp.write(packed)
        self._tmp.write(key_blob)
        self._tmp.seek(0)
        self._tmp.write(_HEADER.pack(_MAGIC, len(entries), index_offset))
        self._tmp.close()
        os.replace(self.path + ".tmp", self.path)

    def abort(self) -> None:
        """Discard the partial store (leaves any existing file untouched)."""
        try:
            self._tmp.close()
        finally:
            try:
                os.remove(self.path + ".tmp")
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        # finalizing a partially-written store on error would os.replace a
        # truncated DB over a good one — abort instead
        if exc_type is not None:
            self.abort()
        else:
            self.close()

    @classmethod
    def write_dict(cls, path: str, items: Iterable[Tuple[Union[str, bytes],
                                                          Bytes]]) -> None:
        with cls(path) as w:
            for k, v in items:
                w.put(k, v)


class _PyReader:
    """Pure-python mmap reader (same format)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, self.n, index_offset = _HEADER.unpack_from(self._mm, 0)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an ldkv file")
        self._index: Dict[bytes, Tuple[int, int]] = {}
        key_blob_off = index_offset + self.n * _ENTRY.size
        for i in range(self.n):
            h, koff, klen, _, voff, vlen = _ENTRY.unpack_from(
                self._mm, index_offset + i * _ENTRY.size)
            key = bytes(self._mm[key_blob_off + koff:
                                 key_blob_off + koff + klen])
            self._index[key] = (voff, vlen)
        self._keys = list(self._index.keys())

    def get(self, key: bytes) -> Optional[memoryview]:
        hit = self._index.get(key)
        if hit is None:
            return None
        off, ln = hit
        return memoryview(self._mm)[off:off + ln]

    def keys(self):
        return self._keys

    def close(self):
        # Values are zero-copy views into the mapping, so the mapping must
        # outlive them: close() only blocks further reads; the mmap is torn
        # down at GC (mmap.close() would raise BufferError while any view
        # is exported — and the native backend would dangle).
        self._index = {}
        self._keys = []
        self._f.close()

    def __del__(self):
        try:
            self._mm.close()
        except Exception:
            pass


class _NativeReader:
    def __init__(self, path: str, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.ldkv_open(path.encode())
        if not self._h:
            raise OSError(f"ldkv_open failed for {path}")
        self.n = lib.ldkv_count(self._h)

    def get(self, key: bytes) -> Optional[memoryview]:
        if getattr(self, "_closed", False):
            raise ValueError("reader is closed")
        val = ctypes.c_void_p()
        vlen = ctypes.c_uint64()
        ok = self._lib.ldkv_get(self._h, key, len(key),
                                ctypes.byref(val), ctypes.byref(vlen))
        if not ok:
            return None
        return memoryview((ctypes.c_char * vlen.value).from_address(val.value)
                          ).cast("B")

    def keys(self):
        out = []
        kptr = ctypes.c_void_p()
        klen = ctypes.c_uint32()
        for i in range(self.n):
            if self._lib.ldkv_key_at(self._h, i, ctypes.byref(kptr),
                                     ctypes.byref(klen)):
                out.append(ctypes.string_at(kptr.value, klen.value))
        return out

    def close(self):
        # see _PyReader.close: outstanding views point into the mapping, so
        # the actual munmap is deferred to GC; close() blocks further reads
        self._closed = True

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ldkv_close(h)


class KVReader:
    """Read-only handle; native if available, python otherwise."""

    def __init__(self, path: str, prefer_native: bool = True):
        self.path = path
        lib = native_lib() if prefer_native else None
        self._impl = _NativeReader(path, lib) if lib else _PyReader(path)
        self.native = isinstance(self._impl, _NativeReader)

    def __len__(self) -> int:
        return int(self._impl.n)

    def __contains__(self, key: Union[str, bytes]) -> bool:
        return self.get(key) is not None

    def get(self, key: Union[str, bytes]) -> Optional[memoryview]:
        key_b = key.encode("utf-8") if isinstance(key, str) else key
        return self._impl.get(key_b)

    def __getitem__(self, key: Union[str, bytes]) -> memoryview:
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def keys(self) -> list:
        # surrogateescape keeps non-UTF-8 byte keys enumerable (put()
        # accepts raw bytes); they round-trip via .encode("utf-8",
        # "surrogateescape")
        return [k.decode("utf-8", "surrogateescape")
                for k in self._impl.keys()]

    def close(self) -> None:
        self._impl.close()
