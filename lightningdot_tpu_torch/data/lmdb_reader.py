"""Read-only LMDB access for reference-DB ingestion (the port's copy of
lightningdot_tpu/data/lmdb_reader.py).

The reference distributes its datasets as LMDB environments
(uniter_model/data/data.py:69-72,137-174: ``lmdb.open(db_dir, readonly=
True)`` + a read transaction).  Neither the ``lmdb`` package nor liblmdb
is a dependency of this repository, so ``cli/prepro from-lmdb`` carries its own
read-only reader: a mmap walk of the LMDB B-tree, written from the
published file-format structs (lmdb.h / mdb.c layout for the 64-bit
little-endian build every released artifact uses).

Backend selection: the battle-tested ``lmdb`` package is preferred when
importable (artifact-day environments that have it); otherwise the pure
reader below.  Both expose the same 3-method surface via :func:`open_lmdb`.

Scope: plain (unnamed main DB, no DUPSORT) environments — exactly what
TxtLmdb / DetectFeatLmdb create.  Anything else raises loudly.
"""
from __future__ import annotations

import mmap
import os
import struct
from bisect import bisect_right
from typing import Iterator, Optional, Tuple

# page flags (mdb.c)
_P_BRANCH, _P_LEAF, _P_OVERFLOW, _P_META, _P_LEAF2 = (
    0x01, 0x02, 0x04, 0x08, 0x20)
# leaf-node flags
_F_BIGDATA, _F_SUBDATA, _F_DUPDATA = 0x01, 0x02, 0x04
# db flags we refuse (reference DBs are plain)
_MDB_DUPSORT, _MDB_DUPFIXED = 0x04, 0x10

_MAGIC = 0xBEEFC0DE
_DATA_VERSION = 1
_P_INVALID = 0xFFFFFFFFFFFFFFFF
_PAGEHDRSZ = 16
# MDB_meta layout after the 16-byte page header:
#   u32 magic, u32 version, u64 address, u64 mapsize,
#   MDB_db dbs[2], u64 last_pg, u64 txnid
# MDB_db: u32 pad, u16 flags, u16 depth, u64 branch_pages, u64 leaf_pages,
#   u64 overflow_pages, u64 entries, u64 root   (48 bytes)
_MDB_DB = struct.Struct("<IHHQQQQQ")
_META_HEAD = struct.Struct("<IIQQ")


class LmdbFormatError(ValueError):
    pass


class _Db:
    __slots__ = ("pad", "flags", "depth", "branch_pages", "leaf_pages",
                 "overflow_pages", "entries", "root")

    def __init__(self, raw: bytes):
        (self.pad, self.flags, self.depth, self.branch_pages,
         self.leaf_pages, self.overflow_pages, self.entries,
         self.root) = _MDB_DB.unpack(raw)


class PureLmdbReader:
    """mmap B-tree walker over a single LMDB data file (read-only)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = open(path, "rb")
        self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._load_meta()

    # -- file structure -----------------------------------------------------

    def _load_meta(self) -> None:
        m = self._m
        if len(m) < 2 * 4096:
            raise LmdbFormatError(f"{self.path}: too small for LMDB")
        best = None
        # the two meta pages sit at offsets 0 and psize; psize itself is
        # recorded in meta.dbs[0].pad, so probe the common sizes
        for psize in (4096, 8192, 16384, 32768, 65536, 1024, 2048, 512):
            for off in (0, psize):
                if off + 152 > len(m):
                    continue
                flags = struct.unpack_from("<H", m, off + 10)[0]
                if not flags & _P_META:
                    continue
                magic, version, _addr, _mapsize = _META_HEAD.unpack_from(
                    m, off + _PAGEHDRSZ)
                if magic != _MAGIC:
                    continue
                if version != _DATA_VERSION:
                    raise LmdbFormatError(
                        f"{self.path}: LMDB data version {version} "
                        f"(expected {_DATA_VERSION})")
                base = off + _PAGEHDRSZ + _META_HEAD.size
                free_db = _Db(m[base:base + 48])
                main_db = _Db(m[base + 48:base + 96])
                txnid = struct.unpack_from("<Q", m, base + 96 + 8)[0]
                if free_db.pad != psize:
                    continue  # wrong psize guess: dbs[0].pad holds it
                if best is None or txnid > best[0]:
                    best = (txnid, psize, main_db)
            if best is not None:
                break
        if best is None:
            raise LmdbFormatError(
                f"{self.path}: no valid LMDB meta page (64-bit "
                "little-endian env expected)")
        _txnid, self.psize, self.main = best
        if self.main.flags & (_MDB_DUPSORT | _MDB_DUPFIXED):
            raise LmdbFormatError(
                f"{self.path}: DUPSORT databases are out of scope "
                "(reference DBs are plain)")

    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if pgno == _P_INVALID or off + _PAGEHDRSZ > len(self._m):
            raise LmdbFormatError(f"{self.path}: bad page {pgno}")
        return off

    def _nodes(self, off: int) -> Tuple[int, list]:
        """(flags, [node offsets]) for a branch/leaf page."""
        flags, lower = struct.unpack_from("<HH", self._m, off + 10)
        if flags & _P_LEAF2:
            raise LmdbFormatError("LEAF2 (DUPFIXED) pages unsupported")
        n = (lower - _PAGEHDRSZ) // 2
        ptrs = struct.unpack_from(f"<{n}H", self._m, off + _PAGEHDRSZ)
        return flags, [off + p for p in ptrs]

    def _node(self, noff: int):
        lo, hi, nflags, ksize = struct.unpack_from("<HHHH", self._m, noff)
        key = self._m[noff + 8:noff + 8 + ksize]
        return lo, hi, nflags, ksize, key

    def _leaf_value(self, noff: int) -> bytes:
        lo, hi, nflags, ksize, _key = self._node(noff)
        dsize = lo | (hi << 16)
        if nflags & (_F_SUBDATA | _F_DUPDATA):
            raise LmdbFormatError("DUPSORT leaf nodes unsupported")
        dstart = noff + 8 + ksize
        if nflags & _F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", self._m, dstart)[0]
            ooff = self._page(ovf_pgno)
            oflags = struct.unpack_from("<H", self._m, ooff + 10)[0]
            if not oflags & _P_OVERFLOW:
                raise LmdbFormatError(
                    f"{self.path}: BIGDATA points at non-overflow page")
            start = ooff + _PAGEHDRSZ
            if start + dsize > len(self._m):
                raise LmdbFormatError(f"{self.path}: overflow value "
                                      "runs past end of file")
            return self._m[start:start + dsize]
        return self._m[dstart:dstart + dsize]

    def _branch_child(self, noff: int) -> int:
        lo, hi, nflags, _ksize, _key = self._node(noff)
        return lo | (hi << 16) | (nflags << 32)

    # -- public surface -----------------------------------------------------

    def __len__(self) -> int:
        return self.main.entries

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs in key order (full B-tree DFS)."""
        if self.main.root == _P_INVALID:
            return
        stack = [self._page(self.main.root)]
        while stack:
            off = stack.pop()
            flags, noffs = self._nodes(off)
            if flags & _P_LEAF:
                for noff in noffs:
                    _lo, _hi, _nf, ksize, key = self._node(noff)
                    yield bytes(key), bytes(self._leaf_value(noff))
            elif flags & _P_BRANCH:
                # push right-to-left so children pop in key order
                for noff in reversed(noffs):
                    stack.append(self._page(self._branch_child(noff)))
            else:
                raise LmdbFormatError(
                    f"{self.path}: unexpected page flags {flags:#x}")

    def get(self, key: bytes) -> Optional[bytes]:
        if self.main.root == _P_INVALID:
            return None
        off = self._page(self.main.root)
        while True:
            flags, noffs = self._nodes(off)
            keys = [self._node(noff)[4] for noff in noffs]
            if flags & _P_BRANCH:
                # child i covers [keys[i], keys[i+1]); keys[0] acts as -inf
                i = bisect_right(keys[1:], key)
                off = self._page(self._branch_child(noffs[i]))
            elif flags & _P_LEAF:
                lo = bisect_right(keys, key) - 1
                if lo >= 0 and keys[lo] == key:
                    return bytes(self._leaf_value(noffs[lo]))
                return None
            else:
                raise LmdbFormatError(
                    f"{self.path}: unexpected page flags {flags:#x}")

    def close(self) -> None:
        self._m.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _PackageLmdbReader:
    """Same surface over the ``lmdb`` package (preferred when available)."""

    def __init__(self, path: str):
        import lmdb  # noqa: F811

        subdir = os.path.isdir(path)
        self.env = lmdb.open(path, readonly=True, create=False,
                             subdir=subdir, lock=False, readahead=True)
        self.txn = self.env.begin(buffers=False)

    def __len__(self) -> int:
        return self.env.stat()["entries"]

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        with self.txn.cursor() as cur:
            for k, v in cur:
                yield bytes(k), bytes(v)

    def get(self, key: bytes) -> Optional[bytes]:
        return self.txn.get(key)

    def close(self) -> None:
        self.env.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_lmdb(path: str, *, backend: str = "auto"):
    """Open an LMDB environment dir (or data.mdb file) read-only.

    backend: 'auto' (lmdb package if importable, else the pure reader),
    'pure', or 'package'.
    """
    if backend not in ("auto", "pure", "package"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "pure":
        try:
            import lmdb  # noqa: F401

            return _PackageLmdbReader(path)
        except ImportError:
            if backend == "package":
                raise
    return PureLmdbReader(path)
