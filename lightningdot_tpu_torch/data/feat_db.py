"""Region-feature database (the port's copy of
lightningdot_tpu/data/feat_db.py, writer included; reference
DetectFeatLmdb, data.py:44-125).

Directory contract mirrors the reference image DBs:

  <img_dir>/feat_th{conf}_max{max_bb}_min{min_bb}.ldkv     (or feat_numbb{n})
  <img_dir>/nbb_th{conf}_max{max_bb}_min{min_bb}.json      (fname -> nbb)

Each record value is a raw record (a msgpack header and the arrays' bytes,
read zero-copy out of the mapping) or an .npz payload, with at least
``features`` [nbb, 2048] and ``norm_bb`` [nbb, 6] (plus ``conf`` /
``soft_labels`` when present), the arrays the reference stores
(data.py:110-122). Reads keep the stored dtype (float16 features stay
float16; the model casts on the device); ``get_dump`` returns float32.

The 7-d position feature is derived exactly as the reference does:
``img_bb = cat([bb, bb[:,4]*bb[:,5]])`` (data.py:247-251).
"""
from __future__ import annotations

import io
import json
from collections import defaultdict
from os.path import exists, join
from typing import Dict, Tuple

import numpy as np

from lightningdot_tpu_torch.data.kvstore import KVReader, KVWriter


def compute_num_bb(confs: np.ndarray, conf_th: float, min_bb: int,
                   max_bb: int) -> int:
    """data.py:30-33."""
    num_bb = max(min_bb, int((confs > conf_th).sum()))
    return min(max_bb, num_bb)


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


_RAW_MAGIC = b"LDRW"


def _raw_bytes(**arrays) -> bytes:
    """Zero-copy record format: msgpack header + raw array payloads, read
    straight out of the ldkv mmap with np.frombuffer (no copy, no
    decompression, which costs milliseconds per image for npz records).
    """
    import msgpack

    header = {}
    payloads = []
    offset = 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        header[name] = [arr.dtype.str, list(arr.shape), offset]
        payloads.append(arr.tobytes())
        offset += len(payloads[-1])
    head = msgpack.dumps(header)
    return b"".join([_RAW_MAGIC, len(head).to_bytes(4, "little"), head]
                    + payloads)


class _OwnedArray(np.ndarray):
    """Zero-copy view into a kvstore mapping that PINS its reader.

    The native reader's memoryviews point into an mmap that
    ``_NativeReader.__del__`` unmaps — a plain frombuffer array keeps the
    ctypes buffer object alive but NOT the reader, so dropping the
    DetectFeatDb while loader batches still hold un-copied feature arrays
    would leave them dangling (segfault on next read). Holding the owner
    on the array defers the munmap until every view is gone. Views/
    reshapes propagate the subclass and base chain; copies detach.
    """

    _owner = None


def _raw_load(view: memoryview, owner=None) -> Dict[str, np.ndarray]:
    import msgpack

    head_len = int.from_bytes(view[4:8], "little")
    header = msgpack.loads(bytes(view[8:8 + head_len]), raw=False)
    base = 8 + head_len
    out = {}
    for name, (dtype, shape, offset) in header.items():
        n = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(view, dtype=np.dtype(dtype),
                            count=n, offset=base + offset)
        if owner is not None:
            arr = arr.view(_OwnedArray)
            arr._owner = owner
        out[name] = arr.reshape(shape)
    return out


class DetectFeatDb:
    """Read-side feature DB."""

    def __init__(self, img_dir: str, conf_th: float = 0.2, max_bb: int = 100,
                 min_bb: int = 10, num_bb: int = 36):
        self.img_dir = img_dir
        self.conf_th = conf_th
        self.max_bb = max_bb
        self.min_bb = min_bb
        if conf_th == -1:
            db_name = f"feat_numbb{num_bb}"
            self.name2nbb: Dict[str, int] = defaultdict(lambda: num_bb)
        else:
            db_name = f"feat_th{conf_th}_max{max_bb}_min{min_bb}"
            nbb_file = join(img_dir,
                            f"nbb_th{conf_th}_max{max_bb}_min{min_bb}.json")
            if exists(nbb_file):
                with open(nbb_file) as f:
                    self.name2nbb = json.load(f)
            else:
                self.name2nbb = None
        self.db = KVReader(join(img_dir, db_name + ".ldkv"))
        if self.name2nbb is None:
            self.name2nbb = self._compute_nbb()

    def _compute_nbb(self) -> Dict[str, int]:
        """data.py:76-91: derive nbb from stored confidences."""
        name2nbb = {}
        for fname in self.db.keys():
            dump = self._load(fname)
            name2nbb[fname] = compute_num_bb(dump["conf"], self.conf_th,
                                             self.min_bb, self.max_bb)
        return name2nbb

    def _load(self, file_name: str) -> Dict[str, np.ndarray]:
        """Record arrays in their STORED dtypes (possibly f16): the batch
        keeps the stored dtype end to end (padding.pad_feats emits an f16
        batch for f16 records; the model casts to its compute dtype on the
        device, and f16->f32/bf16 is value-preserving)."""
        raw = self.db[file_name]
        if bytes(raw[:4]) == _RAW_MAGIC:
            return _raw_load(raw, owner=self.db)
        with io.BytesIO(bytes(raw)) as reader:  # npz (reference records)
            dump = np.load(reader, allow_pickle=True)
            return {k: np.asarray(dump[k]) for k in dump.files}

    def load_arrays(self, file_name: str) -> Dict[str, np.ndarray]:
        """Public record access in STORED dtypes, untruncated — the
        dtype-preserving path MrcDataset consumes (get_dump's f32 upcast
        is reference-API parity only)."""
        return self._load(file_name)

    def get_dump(self, file_name: str) -> Dict[str, np.ndarray]:
        """All arrays truncated to nbb, f32 (data.py:96-108 parity API)."""
        nbb = self.name2nbb[file_name]
        dump = self._load(file_name)
        return {k: (arr[:nbb, ...].astype(np.float32, copy=False)
                    if arr.dtype == np.float16 else arr[:nbb, ...])
                for k, arr in dump.items()}

    def __getitem__(self, file_name: str) -> Tuple[np.ndarray, np.ndarray]:
        """-> (img_feat [nbb, d], img_bb [nbb, 6]) (data.py:110-122).

        Arrays keep their stored dtype (f16 or f32); every consumer either
        pads into an f32 batch (exact conversion on assignment) or casts
        explicitly."""
        nbb = self.name2nbb[file_name]
        dump = self._load(file_name)
        return dump["features"][:nbb], dump["norm_bb"][:nbb]

    def __contains__(self, file_name: str) -> bool:
        return file_name in self.db

    def get_img_feat(self, fname: str
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
        """-> (feat, 7-d pos feat, nbb) (data.py:247-251)."""
        img_feat, bb = self[fname]
        # the area column (w*h) is computed in f32 regardless of the
        # stored dtype so values match the f32 reference bit-for-bit
        bb = bb.astype(np.float32, copy=False)
        img_bb = np.concatenate([bb, bb[:, 4:5] * bb[:, 5:6]], axis=-1)
        return img_feat, img_bb, img_feat.shape[0]


class ImageDbGroup:
    """Path-keyed cache of DetectFeatDb (ImageLmdbGroup, data.py:319-333)."""

    def __init__(self, conf_th: float, max_bb: int, min_bb: int, num_bb: int,
                 compress: bool = True):
        del compress  # ldkv payloads are already npz-compressed
        self.path2imgdb: Dict[str, DetectFeatDb] = {}
        self.conf_th = conf_th
        self.max_bb = max_bb
        self.min_bb = min_bb
        self.num_bb = num_bb

    def __getitem__(self, path: str) -> DetectFeatDb:
        img_db = self.path2imgdb.get(path)
        if img_db is None:
            img_db = DetectFeatDb(path, self.conf_th, self.max_bb,
                                  self.min_bb, self.num_bb)
            self.path2imgdb[path] = img_db
        return img_db


def write_feat_db(img_dir: str, records: Dict[str, Dict[str, np.ndarray]],
                  conf_th: float = 0.2, max_bb: int = 100, min_bb: int = 10,
                  num_bb: int = 36, fmt: str = "raw") -> None:
    """Prepro-side writer (parity with scripts/convert_imgdir.py outputs).

    records: fname -> {features, norm_bb, conf[, soft_labels]}, or an
    iterable of (fname, arrays) pairs (streaming conversion).
    fmt: 'raw' (zero-copy mmap reads, default) or 'npz' (compressed,
    reference-equivalent).
    """
    import os

    os.makedirs(img_dir, exist_ok=True)
    if conf_th == -1:
        db_name = f"feat_numbb{num_bb}"
    else:
        db_name = f"feat_th{conf_th}_max{max_bb}_min{min_bb}"
    pack = _raw_bytes if fmt == "raw" else _npz_bytes
    name2nbb = {}
    items = records.items() if hasattr(records, "items") else records
    with KVWriter(join(img_dir, db_name + ".ldkv")) as w:
        for fname, arrays in items:
            w.put(fname, pack(**arrays))
            if conf_th != -1:
                name2nbb[fname] = compute_num_bb(
                    np.asarray(arrays["conf"]), conf_th, min_bb, max_bb)
    if conf_th != -1:
        nbb_file = join(img_dir,
                        f"nbb_th{conf_th}_max{max_bb}_min{min_bb}.json")
        with open(nbb_file, "w") as f:
            json.dump(name2nbb, f)
