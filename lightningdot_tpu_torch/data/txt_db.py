"""Tokenized-text database (the port's copy of
lightningdot_tpu/data/txt_db.py, writer included; reference TxtTokLmdb,
data.py:177-224).

Directory contract (identical side files to the reference):

  <db_dir>/data.ldkv       — id -> msgpack dict {input_ids, img_fname, ...}
  <db_dir>/id2len.json     — id -> token length
  <db_dir>/meta.json       — {CLS, SEP, MASK, v_range, ...}
  <db_dir>/txt2img.json    — txt id -> img fname
  <db_dir>/img2txts.json   — img fname -> [txt ids]

Rank sharding reproduces ``ids[rank::world]`` (data.py:185-187) so each
process reads a disjoint strided slice.
"""
from __future__ import annotations

import json
from os.path import join
from typing import Any, Dict, List, Optional, Sequence, Tuple

import msgpack

from lightningdot_tpu_torch.data.kvstore import KVReader, KVWriter


class TxtTokDb:
    def __init__(self, db_dir: str, max_txt_len: int = 60,
                 rank: int = 0, world_size: int = 1):
        self.db_dir = db_dir
        with open(join(db_dir, "id2len.json")) as f:
            self.id2len: Dict[str, int] = json.load(f)
        if max_txt_len == -1:
            ids = list(self.id2len.keys())
        else:
            ids = [i for i, l in self.id2len.items() if l <= max_txt_len]
        if world_size > 1:
            ids = ids[rank::world_size]  # data.py:185-187
        self.ids = ids
        self.db = KVReader(join(db_dir, "data.ldkv"))
        with open(join(db_dir, "meta.json")) as f:
            meta = json.load(f)
        self.cls_ = meta["CLS"]
        self.sep = meta["SEP"]
        self.mask = meta["MASK"]
        self.v_range = meta["v_range"]

    def __getitem__(self, id_: str) -> Dict[str, Any]:
        return msgpack.loads(bytes(self.db[id_]), raw=False)

    def combine_inputs(self, *inputs: Sequence[int]) -> List[int]:
        """[CLS] ids [SEP] (ids [SEP])* (data.py:200-204)."""
        out = [self.cls_]
        for ids in inputs:
            out.extend(list(ids) + [self.sep])
        return out

    @property
    def txt2img(self) -> Dict[str, str]:
        if not hasattr(self, "_txt2img"):
            with open(join(self.db_dir, "txt2img.json")) as f:
                self._txt2img = json.load(f)
        return self._txt2img

    @property
    def img2txts(self) -> Dict[str, List[str]]:
        if not hasattr(self, "_img2txts"):
            with open(join(self.db_dir, "img2txts.json")) as f:
                self._img2txts = json.load(f)
        return self._img2txts


def get_ids_and_lens(db: TxtTokDb) -> Tuple[List[int], List[str]]:
    """data.py:217-224."""
    lens = [db.id2len[i] for i in db.ids]
    return lens, list(db.ids)


def write_txt_db(db_dir: str, examples: Dict[str, Dict[str, Any]],
                 meta: Dict[str, Any],
                 txt2img: Optional[Dict[str, str]] = None,
                 img2txts: Optional[Dict[str, List[str]]] = None) -> None:
    """Prepro-side writer.

    examples: id -> {'input_ids': [...], 'img_fname': str, ...}. id2len is
    derived from len(input_ids) (matching prepro.py token-length bookkeeping).
    """
    import os

    os.makedirs(db_dir, exist_ok=True)
    id2len = {}
    with KVWriter(join(db_dir, "data.ldkv")) as w:
        for id_, ex in examples.items():
            w.put(id_, msgpack.dumps(ex, use_bin_type=True))
            id2len[id_] = len(ex["input_ids"])
    with open(join(db_dir, "id2len.json"), "w") as f:
        json.dump(id2len, f)
    with open(join(db_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    if txt2img is None:
        txt2img = {i: ex["img_fname"] for i, ex in examples.items()
                   if "img_fname" in ex}
    with open(join(db_dir, "txt2img.json"), "w") as f:
        json.dump(txt2img, f)
    if img2txts is None:
        img2txts = {}
        for t, im in txt2img.items():
            img2txts.setdefault(im, []).append(t)
    with open(join(db_dir, "img2txts.json"), "w") as f:
        json.dump(img2txts, f)
