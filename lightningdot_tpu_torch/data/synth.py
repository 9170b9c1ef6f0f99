"""Synthetic dataset generation (the port's copy of
lightningdot_tpu/data/synth.py: test fixtures, chip runs and benchmarks).

Builds feature/text DBs with the exact directory contracts of the real
pipeline, through the port's ``write_feat_db`` and ``write_txt_db``, so
every downstream component (datasets, collates, eval and training
drivers, benchmarks) can run without the proprietary Flickr30k/COCO
artifacts. The same arguments give the JAX package's records bit for bit
(``numpy.random.default_rng(seed)`` draws in the same order;
tests/test_torch_imports.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from lightningdot_tpu_torch.data.feat_db import write_feat_db
from lightningdot_tpu_torch.data.txt_db import write_txt_db

DEFAULT_META = {
    # bert-base-cased special ids (the towers' vocab, config/img_base.json)
    "CLS": 101, "SEP": 102, "MASK": 103, "v_range": [106, 28996],
    "UNK": 100, "vocab": 28996,
    "toker": "bert-base-cased",
}


def make_synth_dataset(root: str, *, n_imgs: int = 32, txts_per_img: int = 5,
                       img_dim: int = 2048, min_bb: int = 10,
                       max_bb: int = 100, conf_th: float = 0.2,
                       max_txt_len: int = 40, n_labels: int = 1601,
                       with_soft_labels: bool = False, seed: int = 0,
                       vqa_answers: int = 0) -> Tuple[str, str]:
    """Create <root>/img and <root>/txt_db; returns (txt_db_dir, img_dir)."""
    rng = np.random.default_rng(seed)
    img_dir = f"{root}/img"
    txt_dir = f"{root}/txt_db"

    feat_records: Dict[str, Dict[str, np.ndarray]] = {}
    for i in range(n_imgs):
        fname = f"synth_{i:06d}.npz"
        nbb = int(rng.integers(min_bb, max_bb + 1))
        # confidences chosen so compute_num_bb reproduces nbb exactly
        conf = np.full((nbb,), conf_th + 0.5, np.float32)
        x1y1 = rng.random((nbb, 2)).astype(np.float32) * 0.5
        wh = rng.random((nbb, 2)).astype(np.float32) * 0.5
        norm_bb = np.concatenate([x1y1, x1y1 + wh, wh], axis=1)  # [nbb, 6]
        rec = {
            "features": rng.standard_normal((nbb, img_dim)).astype(np.float16),
            "norm_bb": norm_bb,
            "conf": conf,
        }
        if with_soft_labels:
            sl = rng.random((nbb, n_labels)).astype(np.float32)
            rec["soft_labels"] = sl / sl.sum(-1, keepdims=True)
        feat_records[fname] = rec
    write_feat_db(img_dir, feat_records, conf_th=conf_th, max_bb=max_bb,
                  min_bb=min_bb)

    lo, hi = DEFAULT_META["v_range"]
    examples = {}
    for i in range(n_imgs):
        fname = f"synth_{i:06d}.npz"
        for c in range(txts_per_img):
            tid = f"txt_{i:06d}_{c}"
            length = int(rng.integers(4, max_txt_len - 2))
            ids = rng.integers(lo, hi, length).tolist()
            examples[tid] = {"input_ids": ids, "img_fname": fname}
            if vqa_answers > 0:
                # soft VQA target: 1-3 answers with scores in (0, 1]
                # (dvl/data/vqa.py:11-17 labels/scores contract)
                k = int(rng.integers(1, 4))
                labels = rng.choice(vqa_answers, size=k,
                                    replace=False).tolist()
                scores = (rng.integers(1, 4, k) / 3.0).tolist()
                examples[tid]["target"] = {"labels": labels,
                                           "scores": scores}
    write_txt_db(txt_dir, examples, DEFAULT_META)
    return txt_dir, img_dir


def synth_wordpiece_vocab(path: str, *, n_roots: int = 9000,
                          n_conts: int = 19900, total: int = 28996,
                          seed: int = 0):
    """Write a synthetic full-size HF-format vocab.txt; returns
    (word-initial pieces, continuation suffixes) for caption synthesis.

    Zero-egress benchmarking/fixture helper: WordPiece runtime depends on
    vocab size and longest-prefix structure, not the specific merges, so a
    locally synthesized cased vocab stands in for bert-base-cased
    (bench.py tokenizer measurement, scripts/perf_prepro_tokenize.py).
    """
    import random

    rng = random.Random(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = set()
    while len(pieces) < n_roots:
        pieces.add("".join(rng.choice(letters)
                           for _ in range(rng.randint(2, 7))))
    subs = set()
    while len(subs) < n_conts:
        subs.add("##" + "".join(rng.choice(letters)
                                for _ in range(rng.randint(1, 5))))
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + sorted(pieces) + sorted(subs))[:total]
    with open(path, "w") as f:
        f.write("\n".join(vocab))
    return sorted(pieces), [s[2:] for s in sorted(subs)]
