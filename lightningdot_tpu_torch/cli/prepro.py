"""Data preprocessing: annotations -> text DBs, npz feature dirs -> feat DBs
(the port's copy of lightningdot_tpu/cli/prepro.py, over the port's
writers and readers). Host work: no card is used.

Parity targets:
  * ``process_image_text_retrieval`` (uniter_model/prepro.py:384-413):
    karpathy-split annotation JSON -> per-sentence records with
    input_ids/img_fname + id2len/txt2img/img2txts side files; coco/flickr
    fname conventions (prepro.py:109-130);
  * ``process_caption`` (prepro.py:313-330): COCO-style caption annotations;
  * ``scripts/convert_imgdir.py``: a directory of per-image .npz region
    features -> feature DB with nbb json (fp32 downcast to fp16, arrays
    truncated to nbb);
  * ``scripts/extract_generated_caption.py:46-74`` ``annotation2json``:
    caption meta JSON for the caption-blending path.

Tokenization: a local vocab file (``--vocab``) builds the port's
WordPiece tokenizer; the JAX CLI's named tokenizer download
(cli/prepro.py:49-51) is not ported, so the ``txt`` task needs
``--vocab``. Records store ``input_ids`` exactly like the reference
(reconstructable word-piece tokenization, prepro.py:25-43). The
``from-lmdb`` task decodes msgpack records and imports ``msgpack`` only
there, as the JAX CLI does.

Usage:
  python -m lightningdot_tpu_torch.cli.prepro txt --annotation ann.json \
      --format caption --vocab vocab.txt --output txt_db
  python -m lightningdot_tpu_torch.cli.prepro img --img_dir npz_dir \
      --output img_db
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from collections import defaultdict
from os.path import basename
from typing import Dict, List

import numpy as np

from lightningdot_tpu_torch.data.feat_db import compute_num_bb, write_feat_db
from lightningdot_tpu_torch.data.txt_db import write_txt_db
from lightningdot_tpu_torch.utils.logging import LOGGER

IN_WORD = "@@"


def get_tokenizer(bert_name: str, vocab_file: str | None):
    """The port's WordPiece tokenizer over ``vocab_file`` (lower-casing for
    an ``uncased`` name). The JAX CLI downloads ``bert_name`` without a
    vocab file; the port does not."""
    if not vocab_file:
        raise ValueError(
            f"prepro txt needs --vocab (a vocab.txt of {bert_name}): the "
            "port does not download tokenizers")
    from lightningdot_tpu_torch.data.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer(vocab_file,
                              do_lower_case="uncased" in bert_name)


def bert_tokenize(tokenizer, text: str):
    """Reconstructable per-word tokenization (prepro.py:25-43)."""
    if hasattr(tokenizer, "encode_words"):
        # one native call per caption instead of a Python loop per word
        # (scripts/perf_prepro_tokenize.py has the throughput ladder)
        ids, starts = tokenizer.encode_words(text)
        toks = tokenizer.convert_ids_to_tokens(ids)
        words = [t if s else f"{IN_WORD}{t}"
                 for t, s in zip(toks, starts)]
        return ids, words
    ids: List[int] = []
    words: List[str] = []
    for word in text.strip().split():
        ws = tokenizer.tokenize(word)
        if not ws:
            continue
        words.append(ws[0])
        for w in ws[1:]:
            words.append(f"{IN_WORD}{w}")
        ids.extend(tokenizer.convert_tokens_to_ids(ws))
    return ids, words


def get_coco_fname(id_: int, split: str) -> str:
    """prepro.py:109-111."""
    return f"coco_{split}_{id_:012}.npz"


def get_flickr_fname(id_: int) -> str:
    """prepro.py:127-129."""
    return f"flickr30k_{id_:012}.npz"


def meta_for(tokenizer) -> Dict:
    return {
        "CLS": tokenizer.cls_token_id,
        "SEP": tokenizer.sep_token_id,
        "MASK": tokenizer.mask_token_id,
        "UNK": tokenizer.unk_token_id,
        "v_range": [tokenizer.convert_tokens_to_ids("!"),
                    tokenizer.vocab_size],
        "vocab": tokenizer.vocab_size,
    }


def process_image_text_retrieval(data, tokenizer, dataset: str, split: str):
    """prepro.py:384-413 -> (examples, txt2img, img2txts)."""
    examples, txt2img = {}, {}
    img2txts = defaultdict(list)
    for q in data:
        filename = q["filename"].split(".jpg")[0]
        image_id = (int(filename.split("_")[-1])
                    if re.search("[a-zA-Z]", filename) else int(filename))
        if dataset == "coco":
            img_fname = get_coco_fname(image_id, split)
        elif dataset == "flickr":
            img_fname = get_flickr_fname(image_id)
        else:
            raise ValueError("unrecognized data")
        for s in q["sentences"]:
            id_ = str(s["sentid"])
            input_ids, toked = bert_tokenize(tokenizer, s["raw"])
            examples[id_] = {
                "sentid": s["sentid"], "raw": s["raw"],
                "toked_caption": toked, "input_ids": input_ids,
                "img_fname": img_fname, "image_id": image_id,
            }
            txt2img[id_] = img_fname
            img2txts[img_fname].append(id_)
    return examples, txt2img, dict(img2txts)


def process_caption(data, tokenizer, split: str):
    """prepro.py:313-330 (COCO caption annotations)."""
    examples, txt2img = {}, {}
    img2txts = defaultdict(list)
    for q in data["annotations"]:
        id_ = str(q["id"])
        input_ids, toked = bert_tokenize(tokenizer, q["caption"])
        img_fname = get_coco_fname(q["image_id"], split)
        examples[id_] = {
            "id": q["id"], "caption": q["caption"],
            "toked_caption": toked, "input_ids": input_ids,
            "img_fname": img_fname, "image_id": q["image_id"],
        }
        txt2img[id_] = img_fname
        img2txts[img_fname].append(id_)
    return examples, txt2img, dict(img2txts)


def process_conceptual_caption(tsv_lines, imgs, tokenizer, split: str):
    """Conceptual Captions tsv -> records (prepro.py:331-355).

    Row format: ``id \\t url \\t caption \\t success|fail``; only successful
    downloads whose feature file exists in ``imgs`` are kept. ``imgs`` may be
    None to skip the existence filter (features converted later).
    """
    examples, txt2img = {}, {}
    img2txts = defaultdict(list)
    for line in tsv_lines:
        line = line.strip()
        if not line:
            continue
        fields = line.split("\t")
        assert len(fields) == 4, f"bad CC row: {line!r}"
        id_, _, caption, success = fields
        if success == "fail":
            continue
        assert success == "success", f"bad CC status: {success!r}"
        input_ids, toked = bert_tokenize(tokenizer, caption)
        assert input_ids  # safeguard for empty text (prepro.py:342)
        img_fname = f"gcc_{split}_{int(id_):012}.npz"
        if imgs is not None and img_fname not in imgs:
            continue
        examples[id_] = {
            "id": id_, "toked_caption": toked, "input_ids": input_ids,
            "img_fname": img_fname,
        }
        txt2img[id_] = img_fname
        img2txts[img_fname].append(id_)
    return examples, txt2img, dict(img2txts)


def process_sbu_caption(data, tokenizer):
    """SBU caption json -> records (prepro.py:358-381).

    ``data``: list of {'iid', 'sent', 'file_path'} entries; the known
    corrupted image 0347/565.jpg is skipped, and numeric iids are
    canonicalized through int() (the reference's feature-extraction quirk).
    """
    examples, txt2img = {}, {}
    img2txts = defaultdict(list)
    for ex in data:
        if ex["file_path"] == "0347/565.jpg":
            # special case for corrupted image (prepro.py:362-364)
            continue
        id_ = ex["iid"]
        input_ids, toked = bert_tokenize(tokenizer, ex["sent"])
        assert input_ids  # safeguard for empty text
        try:
            id_ = str(int(id_))  # sbu feature extraction quirk
        except ValueError:
            pass
        img_fname = f"sbu_{id_}.npz"
        examples[id_] = {
            "id": id_, "toked_caption": toked, "input_ids": input_ids,
            "img_fname": img_fname,
        }
        txt2img[id_] = img_fname
        img2txts[img_fname].append(id_)
    return examples, txt2img, dict(img2txts)


def convert_imgdir(img_dir: str, output: str, conf_th: float = 0.2,
                   max_bb: int = 100, min_bb: int = 10, num_bb: int = 36,
                   keep_all: bool = False) -> str:
    """scripts/convert_imgdir.py semantics on the ldkv store."""
    split = basename(img_dir.rstrip("/"))
    out_dir = os.path.join(output, split)
    files = sorted(glob.glob(f"{img_dir}/*.npz"))
    records = {}
    for fname in files:
        try:
            dump = dict(np.load(fname, allow_pickle=True))
        except Exception as e:  # corrupted file (convert_imgdir.py:46-50)
            LOGGER.warning("corrupted file %s: %s", fname, e)
            continue
        nbb = None
        if not keep_all:
            nbb = compute_num_bb(dump["conf"], conf_th, min_bb, max_bb)
        rec = {}
        for key, arr in dump.items():
            if arr.dtype == np.float32:
                arr = arr.astype(np.float16)
            rec[key] = arr[:nbb] if arr.ndim in (1, 2) else arr
        records[basename(fname)] = rec
    write_feat_db(out_dir, records, conf_th=-1 if keep_all else conf_th,
                  max_bb=max_bb, min_bb=min_bb, num_bb=num_bb)
    LOGGER.info("wrote %d image records to %s", len(records), out_dir)
    return out_dir


def _decode_msgpack_numpy(obj):
    """Decode msgpack_numpy's array encoding without the package.

    msgpack_numpy packs an ndarray as {b'nd': True, b'type': '<f2',
    b'kind': b'', b'shape': [...], b'data': <bin>}; the reference's
    uncompressed image DBs store records this way
    (uniter_model/data/data.py:85-125 msgpack branch)."""
    if isinstance(obj, dict):
        nd = obj.get(b"nd", obj.get("nd"))
        if nd is True:
            dtype = obj.get(b"type", obj.get("type"))
            if isinstance(dtype, bytes):
                dtype = dtype.decode("ascii")
            shape = obj.get(b"shape", obj.get("shape"))
            data = obj.get(b"data", obj.get("data"))
            return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
        return {(k.decode("utf-8") if isinstance(k, bytes) else k):
                _decode_msgpack_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_decode_msgpack_numpy(v) for v in obj]
    return obj


def convert_lmdb_txt(src: str, output: str, backend: str = "auto") -> int:
    """Reference text LMDB (.db dir) -> ldkv text DB.

    Source layout (uniter_model/data/data.py:137-174): data.mdb whose
    values are lz4.frame(msgpack(record)), plus id2len/meta/txt2img/
    img2txts side jsons.  Values are stored VERBATIM after lz4 decode (the
    decompressed bytes already are the msgpack record TxtTokDb expects),
    so conversion is lossless by construction.  Missing side jsons are
    derived from the records.
    """
    import msgpack

    from lightningdot_tpu_torch.data.kvstore import KVWriter
    from lightningdot_tpu_torch.data.lmdb_reader import open_lmdb
    from lightningdot_tpu_torch.data.lz4frame import decompress

    os.makedirs(output, exist_ok=True)
    n = 0
    id2len: Dict[str, int] = {}
    txt2img: Dict[str, str] = {}
    with open_lmdb(src, backend=backend) as db, \
            KVWriter(os.path.join(output, "data.ldkv")) as w:
        for key, value in db.items():
            id_ = key.decode("utf-8")
            raw = decompress(bytes(value))
            if n == 0:  # loud early validation of the decode chain
                first = msgpack.loads(raw, raw=False)
                if not isinstance(first, dict) or "input_ids" not in first:
                    raise ValueError(
                        f"{src}: first record is not a txt-db dict "
                        f"(got {type(first).__name__}) — wrong --kind?")
            w.put(id_, raw)
            rec = msgpack.loads(raw, raw=False)
            id2len[id_] = len(rec["input_ids"])
            if "img_fname" in rec:
                txt2img[id_] = rec["img_fname"]
            n += 1
    for name in ("id2len.json", "meta.json", "txt2img.json",
                 "img2txts.json"):
        src_json = os.path.join(src, name)
        if os.path.exists(src_json):
            import shutil

            shutil.copy(src_json, os.path.join(output, name))
    # derive whatever the source did not carry
    if not os.path.exists(os.path.join(output, "id2len.json")):
        with open(os.path.join(output, "id2len.json"), "w") as f:
            json.dump(id2len, f)
    if not os.path.exists(os.path.join(output, "txt2img.json")):
        with open(os.path.join(output, "txt2img.json"), "w") as f:
            json.dump(txt2img, f)
    if not os.path.exists(os.path.join(output, "img2txts.json")):
        img2txts: Dict[str, List[str]] = {}
        for t, im in txt2img.items():
            img2txts.setdefault(im, []).append(t)
        with open(os.path.join(output, "img2txts.json"), "w") as f:
            json.dump(img2txts, f)
    if not os.path.exists(os.path.join(output, "meta.json")):
        raise FileNotFoundError(
            f"{src}/meta.json missing — the reference always writes it "
            "(CLS/SEP/MASK/v_range); cannot derive token ids safely")
    LOGGER.info("converted %d text records from %s to %s", n, src, output)
    return n


_FEAT_DIR_RE = re.compile(r"feat_th([\d.]+)_max(\d+)_min(\d+)")
_NUMBB_DIR_RE = re.compile(r"feat_numbb(\d+)")


def convert_lmdb_img(src: str, output: str, conf_th: float | None = None,
                     max_bb: int | None = None, min_bb: int | None = None,
                     num_bb: int = 36, fmt: str = "raw",
                     backend: str = "auto") -> int:
    """Reference image-feature LMDB dir -> ldkv feature DB.

    Source values are .npz payloads (compress=True distribution format) or
    msgpack_numpy records (data.py:81-125); the ``__keys__`` entry is the
    reference's key manifest and is skipped.  bb-count parameters default
    to whatever the source dir name encodes (feat_th.._max.._min.. /
    feat_numbb..), falling back to the reference defaults (0.2/100/10).
    """
    import io as _io

    import msgpack

    from lightningdot_tpu_torch.data.lmdb_reader import open_lmdb

    name = basename(src.rstrip("/"))
    m = _FEAT_DIR_RE.search(name)
    if m:
        conf_th = float(m.group(1)) if conf_th is None else conf_th
        max_bb = int(m.group(2)) if max_bb is None else max_bb
        min_bb = int(m.group(3)) if min_bb is None else min_bb
    mn = _NUMBB_DIR_RE.search(name)
    if mn and conf_th is None:
        conf_th, num_bb = -1.0, int(mn.group(1))
    conf_th = 0.2 if conf_th is None else conf_th
    max_bb = 100 if max_bb is None else max_bb
    min_bb = 10 if min_bb is None else min_bb

    counter = {"n": 0}

    def record_iter(db):
        for key, value in db.items():
            if key == b"__keys__":
                continue
            fname = key.decode("utf-8")
            value = bytes(value)
            if value[:6] == b"\x93NUMPY" or value[:4] == b"PK\x03\x04":
                # .npy / .npz payload (compress=True format, data.py:100-105)
                dump = dict(np.load(_io.BytesIO(value), allow_pickle=True))
            else:
                dump = _decode_msgpack_numpy(
                    msgpack.loads(value, raw=False))
            if not isinstance(dump, dict) or "features" not in dump:
                raise ValueError(
                    f"{src}: record {fname!r} lacks 'features' "
                    "(not an image-feature DB? wrong --kind?)")
            counter["n"] += 1
            yield fname, dump

    with open_lmdb(src, backend=backend) as db:
        write_feat_db(output, record_iter(db), conf_th=conf_th,
                      max_bb=max_bb, min_bb=min_bb, num_bb=num_bb, fmt=fmt)
    LOGGER.info("converted %d image records from %s to %s", counter["n"],
                src, output)
    return counter["n"]


def annotation2json(annotation_file: str, format: str = "flickr",
                    prefix: str = "coco_val2014_", max_len: int = 12
                    ) -> Dict[str, List[str]]:
    """extract_generated_caption.py:46-74 (caption meta)."""
    res = defaultdict(list)
    if format in ("flickr", "flicker"):
        with open(annotation_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                k, v = line.split("\t")
                k = k.split(".")[0]
                k = "flickr30k_" + "0" * (max_len - len(k)) + k + ".npz"
                res[k].append(v)
    elif format == "coco":
        with open(annotation_file) as f:
            labels = json.load(f)["annotations"]
        for l in labels:
            name = str(l["image_id"])
            name = prefix + "0" * (max_len - len(name)) + name + ".npz"
            res[name].append(l["caption"])
    else:
        raise NotImplementedError(format)
    return dict(res)


def parse_rt_log(log_file: str, n_captions: int = 5, max_len: int = 12
                 ) -> Dict[str, List[str]]:
    """Parse generated-caption logs (extract_generated_caption.py:72-88):
    blocks of n_captions lines preceding each 'image <name>.jpg:' marker."""
    with open(log_file) as f:
        lines = [l.strip() for l in f.readlines()]
    idx = [i for i, l in enumerate(lines) if "image " in l and ".jpg:" in l]
    res = {}
    for i in idx:
        captions = lines[max(i - n_captions - 1, 0):i - 1]
        name = (lines[i].split()[1]).split(".")[0]
        name = "flickr30k_" + "0" * (max_len - len(name)) + name + ".npz"
        res[name] = captions
    return res


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's tasks and flags (cli/prepro.py:431-487)."""
    parser = argparse.ArgumentParser("prepro", allow_abbrev=False)
    sub = parser.add_subparsers(dest="task", required=True)

    p_txt = sub.add_parser("txt", help="annotations -> text DB")
    p_txt.add_argument("--annotation", required=True)
    p_txt.add_argument("--output", required=True)
    p_txt.add_argument("--format", default="itm",
                       choices=["itm", "caption", "conceptual", "sbu"])
    p_txt.add_argument("--dataset", default="flickr",
                       choices=["flickr", "coco"])
    p_txt.add_argument("--split", default="val2014")
    p_txt.add_argument("--bert", default="bert-base-cased")
    p_txt.add_argument("--vocab", default=None)
    p_txt.add_argument("--img_db", default=None,
                       help="conceptual: existing feature DB dir used to "
                            "filter texts to downloaded images")

    p_img = sub.add_parser("img", help="npz dir -> feature DB")
    p_img.add_argument("--img_dir", required=True)
    p_img.add_argument("--output", required=True)
    p_img.add_argument("--conf_th", type=float, default=0.2)
    p_img.add_argument("--max_bb", type=int, default=100)
    p_img.add_argument("--min_bb", type=int, default=10)
    p_img.add_argument("--num_bb", type=int, default=36)
    p_img.add_argument("--keep_all", action="store_true")

    p_lmdb = sub.add_parser(
        "from-lmdb", help="reference LMDB DB -> ldkv DB (txt or img)")
    p_lmdb.add_argument("--kind", required=True, choices=["txt", "img"])
    p_lmdb.add_argument("--src", required=True,
                        help="txt: the .db dir (data.mdb + side jsons); "
                             "img: the feat_* LMDB dir")
    p_lmdb.add_argument("--output", required=True)
    p_lmdb.add_argument("--backend", default="auto",
                        choices=["auto", "pure", "package"],
                        help="LMDB reader: the lmdb package when "
                             "importable, else the built-in pure reader")
    p_lmdb.add_argument("--conf_th", type=float, default=None,
                        help="img only; default: parsed from the src "
                             "dir name, then the reference defaults")
    p_lmdb.add_argument("--max_bb", type=int, default=None)
    p_lmdb.add_argument("--min_bb", type=int, default=None)
    p_lmdb.add_argument("--num_bb", type=int, default=36)
    p_lmdb.add_argument("--fmt", default="raw", choices=["raw", "npz"])

    p_meta = sub.add_parser("caption_meta",
                            help="annotations -> img meta json")
    p_meta.add_argument("--annotation", required=True)
    p_meta.add_argument("--output", required=True)
    p_meta.add_argument("--format", default="flickr",
                        choices=["flickr", "coco"])
    p_meta.add_argument("--prefix", default="coco_val2014_")
    return parser


def main(cmds=None):
    args = build_parser().parse_args(cmds)
    if args.task == "txt":
        tokenizer = get_tokenizer(args.bert, args.vocab)
        if args.format == "conceptual":
            imgs = None
            if args.img_db:
                nbb_files = glob.glob(os.path.join(args.img_db, "nbb*.json"))
                assert nbb_files, f"no nbb json under {args.img_db}"
                with open(nbb_files[0]) as f:
                    imgs = set(json.load(f).keys())
            with open(args.annotation) as f:
                examples, txt2img, img2txts = process_conceptual_caption(
                    f, imgs, tokenizer, args.split)
        elif args.format == "sbu":
            with open(args.annotation) as f:
                data = json.load(f)
            examples, txt2img, img2txts = process_sbu_caption(data,
                                                              tokenizer)
        elif args.format == "itm":
            with open(args.annotation) as f:
                data = json.load(f)
            images = data["images"] if isinstance(data, dict) else data
            examples, txt2img, img2txts = process_image_text_retrieval(
                images, tokenizer, args.dataset, args.split)
        else:
            with open(args.annotation) as f:
                data = json.load(f)
            examples, txt2img, img2txts = process_caption(
                data, tokenizer, args.split)
        write_txt_db(args.output, examples, meta_for(tokenizer), txt2img,
                     img2txts)
        LOGGER.info("wrote %d text records to %s", len(examples),
                    args.output)
    elif args.task == "img":
        convert_imgdir(args.img_dir, args.output, args.conf_th, args.max_bb,
                       args.min_bb, args.num_bb, args.keep_all)
    elif args.task == "from-lmdb":
        if args.kind == "txt":
            convert_lmdb_txt(args.src, args.output, backend=args.backend)
        else:
            convert_lmdb_img(args.src, args.output, conf_th=args.conf_th,
                             max_bb=args.max_bb, min_bb=args.min_bb,
                             num_bb=args.num_bb, fmt=args.fmt,
                             backend=args.backend)
    elif args.task == "caption_meta":
        res = annotation2json(args.annotation, args.format, args.prefix)
        with open(args.output, "w") as f:
            json.dump(res, f)
        LOGGER.info("wrote caption meta for %d images to %s", len(res),
                    args.output)


if __name__ == "__main__":
    main()
