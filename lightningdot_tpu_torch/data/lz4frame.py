"""LZ4-frame decompression for reference-DB ingestion, decode only (the
port's copy of lightningdot_tpu/data/lz4frame.py).

The reference's text DBs store ``lz4.frame.compress(msgpack.dumps(...))``
values (uniter_model/data/data.py:16,160-174); neither ``lz4`` nor its
C library is a dependency of this repository, so ingestion carries its
own decoder:

  * fast path: ``native/ldlz4.cc`` via ctypes (also exposes xxh32 and the
    raw block decoder for tests);
  * fallback: a pure-python frame/block decoder (same spec, ~50x slower —
    fine for one-time conversion, and it doubles as the independent
    cross-check of the native decoder in tests);
  * if the ``lz4`` package happens to be importable (artifact-day env),
    it is preferred outright.

``decompress(data)`` is the only function converters need.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

try:  # pragma: no cover - an optional package
    import lz4.frame as _lz4pkg
except ImportError:
    _lz4pkg = None

_MAGIC = 0x184D2204
_SKIP_LO, _SKIP_HI = 0x184D2A50, 0x184D2A5F

_ERRORS = {-2: "bad magic", -3: "truncated input", -4: "dst too small",
           -5: "corrupt stream", -6: "checksum mismatch",
           -7: "unsupported feature"}


class Lz4Error(ValueError):
    pass


def _raise(code: int) -> None:
    raise Lz4Error(f"lz4 decode failed: {_ERRORS.get(code, code)}")


_lib = None
_lib_tried = False


def _native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        from lightningdot_tpu_torch.native import load_native

        lib = load_native("ldlz4")
        if lib is not None:
            lib.ldlz4_decompress.restype = ctypes.c_int64
            lib.ldlz4_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int64, ctypes.c_int]
            lib.ldlz4_content_size.restype = ctypes.c_int64
            lib.ldlz4_content_size.argtypes = [ctypes.c_char_p,
                                               ctypes.c_int64]
            lib.ldlz4_block_decompress.restype = ctypes.c_int64
            lib.ldlz4_block_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int64, ctypes.c_int64]
            lib.ldlz4_xxh32.restype = ctypes.c_uint32
            lib.ldlz4_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_uint32]
        _lib = lib
    return _lib


def content_size(data: bytes) -> int:
    """Declared decompressed size of the (first) frame, -1 when absent."""
    lib = _native()
    if lib is not None:
        got = lib.ldlz4_content_size(data, len(data))
        if got < -1:
            _raise(got)
        return got
    return _py_content_size(data)


def decompress(data: bytes, *, verify: bool = True) -> bytes:
    """Decompress one or more concatenated LZ4 frames."""
    if _lz4pkg is not None:
        return _lz4pkg.decompress(data)
    lib = _native()
    if lib is None:
        return _py_decompress(data, verify=verify)
    size = content_size(data)
    cap = size if size >= 0 else max(4 * len(data), 1 << 16)
    while True:
        dst = ctypes.create_string_buffer(cap)
        got = lib.ldlz4_decompress(data, len(data), dst, cap, int(verify))
        if got == -4:  # frame without content size: grow and retry
            cap *= 4
            continue
        if got < 0:
            _raise(got)
        return dst.raw[:got]


# ---------------------------------------------------------------------------
# pure-python decoder (spec-mirroring fallback + test cross-check)
# ---------------------------------------------------------------------------

def xxh32(data: bytes, seed: int = 0) -> int:
    lib = _native()
    if lib is not None:
        return lib.ldlz4_xxh32(data, len(data), seed)
    return _py_xxh32(data, seed)


_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917, 668265263,
                           374761393)
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def _py_xxh32(data: bytes, seed: int = 0) -> int:
    n, i = len(data), 0
    if n >= 16:
        v1, v2, v3, v4 = ((seed + _P1 + _P2) & _M, (seed + _P2) & _M,
                          seed & _M, (seed - _P1) & _M)
        while i + 16 <= n:
            for j, v in enumerate((v1, v2, v3, v4)):
                w = struct.unpack_from("<I", data, i + 4 * j)[0]
                v = _rotl((v + w * _P2) & _M, 13) * _P1 & _M
                if j == 0:
                    v1 = v
                elif j == 1:
                    v2 = v
                elif j == 2:
                    v3 = v
                else:
                    v4 = v
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while i + 4 <= n:
        h = _rotl((h + struct.unpack_from("<I", data, i)[0] * _P3) & _M,
                  17) * _P4 & _M
        i += 4
    while i < n:
        h = _rotl((h + data[i] * _P5) & _M, 11) * _P1 & _M
        i += 1
    h ^= h >> 15
    h = h * _P2 & _M
    h ^= h >> 13
    h = h * _P3 & _M
    h ^= h >> 16
    return h


def block_decompress(src: bytes, hist: bytes = b"") -> bytes:
    """Decode one raw LZ4 block; ``hist`` is prior decoded output that
    matches may reference (linked-block frames)."""
    out = bytearray(hist)
    base = len(hist)
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        ll = token >> 4
        if ll == 15:
            while True:
                if i >= n:
                    _raise(-3)
                b = src[i]
                i += 1
                ll += b
                if b != 255:
                    break
        if i + ll > n:
            _raise(-3)
        out += src[i:i + ll]
        i += ll
        if i == n:
            break
        if i + 2 > n:
            _raise(-3)
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            _raise(-5)
        ml = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                if i >= n:
                    _raise(-3)
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        for _ in range(ml):  # byte-wise: overlapping matches
            out.append(out[-offset])
    return bytes(out[base:])


def _py_parse_header(data: bytes, pos: int):
    if len(data) - pos < 7:
        _raise(-3)
    flg, bd = data[pos + 4], data[pos + 5]
    if (flg >> 6) != 1 or (flg & 0x02):
        _raise(-7)
    bmax = (bd >> 4) & 7
    if bmax < 4 or bmax > 7 or (bd & 0x8F):
        _raise(-7)
    has_size, has_dict = flg & 0x08, flg & 0x01
    desc_len = 2 + (8 if has_size else 0) + (4 if has_dict else 0)
    if pos + 4 + desc_len + 1 > len(data):
        _raise(-3)
    if has_dict:
        _raise(-7)
    size = (struct.unpack_from("<Q", data, pos + 6)[0] if has_size else -1)
    desc = data[pos + 4:pos + 4 + desc_len]
    if ((_py_xxh32(desc) >> 8) & 0xFF) != data[pos + 4 + desc_len]:
        _raise(-6)
    return {
        "hdr_len": 4 + desc_len + 1,
        "content_size": size,
        "block_checksum": bool(flg & 0x10),
        "content_checksum": bool(flg & 0x04),
        "block_indep": bool(flg & 0x20),
    }


def _py_content_size(data: bytes) -> int:
    pos = 0
    while len(data) - pos >= 8:
        magic = struct.unpack_from("<I", data, pos)[0]
        if _SKIP_LO <= magic <= _SKIP_HI:
            pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
            continue
        break
    if len(data) - pos < 4 or struct.unpack_from("<I", data, pos)[0] != _MAGIC:
        _raise(-2)
    return _py_parse_header(data, pos)["content_size"]


def _py_decompress(data: bytes, *, verify: bool = True) -> bytes:
    out = bytearray()
    pos, n = 0, len(data)
    saw_frame = False
    while pos < n:
        if n - pos < 4:
            _raise(-5 if saw_frame else -3)
        magic = struct.unpack_from("<I", data, pos)[0]
        if _SKIP_LO <= magic <= _SKIP_HI:
            if n - pos < 8:
                _raise(-3)
            pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
            continue
        if magic != _MAGIC:
            _raise(-2)
        h = _py_parse_header(data, pos)
        pos += h["hdr_len"]
        saw_frame = True
        frame_start = len(out)
        while True:
            if n - pos < 4:
                _raise(-3)
            bsz = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            if bsz == 0:
                break
            raw = bool(bsz & 0x80000000)
            blen = bsz & 0x7FFFFFFF
            if pos + blen > n:
                _raise(-3)
            block = data[pos:pos + blen]
            pos += blen
            if h["block_checksum"]:
                if n - pos < 4:
                    _raise(-3)
                if verify and _py_xxh32(block) != struct.unpack_from(
                        "<I", data, pos)[0]:
                    _raise(-6)
                pos += 4
            if raw:
                out += block
            else:
                hist = (b"" if h["block_indep"]
                        else bytes(out[frame_start:]))
                out += block_decompress(block, hist)
        if h["content_checksum"]:
            if n - pos < 4:
                _raise(-3)
            if verify and _py_xxh32(bytes(out[frame_start:])) != \
                    struct.unpack_from("<I", data, pos)[0]:
                _raise(-6)
            pos += 4
        if h["content_size"] >= 0 and \
                len(out) - frame_start != h["content_size"]:
            _raise(-5)
    return bytes(out)
