"""Cross-encoder inference (the port's ``inf_itm``,
lightningdot_tpu/cli/inf_itm.py; reference uniter_model/inf_itm.py): score
every (text, image) pair of an ITM split with a cross-encoder, report the
``itm_eval`` recalls, and write ``results.bin`` = pickle((score_matrix,
txt_ids, img_ids)), which the re-ranker of either package reads
(``--score_file``).

It runs on the card by default, or on the CPU with ``--device cpu``.

Usage:
  python -m lightningdot_tpu_torch.cli.inf_itm --txt_db ... --img_db ... \\
      --checkpoint teacher_dir --model_config configs/img_base.json \\
      --output_dir out
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import torch

from lightningdot_tpu_torch.config import parse_with_config, print_args
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.txt_db import TxtTokDb
from lightningdot_tpu_torch.models.factory import load_cross_encoder
from lightningdot_tpu_torch.training.cross_scorer import CrossScorer
from lightningdot_tpu_torch.utils.logging import LOGGER
from lightningdot_tpu_torch.utils.metrics import itm_eval
from lightningdot_tpu_torch.utils.runtime import setup_runtime


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("inf_itm", allow_abbrev=False)
    p.add_argument("--txt_db", required=True)
    p.add_argument("--img_db", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="teacher directory, or a .pt of the cross-encoder")
    p.add_argument("--model_config", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--conf_th", default=0.2, type=float)
    p.add_argument("--max_bb", default=100, type=int)
    p.add_argument("--min_bb", default=10, type=int)
    p.add_argument("--num_bb", default=36, type=int)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--config", default=None)
    p.add_argument("--compute_dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--device", default=None, type=str,
                   help="default: the CUDA card (raises without one); "
                        "'cpu' runs the plain PyTorch path")
    return p


def main(cmds=None):
    """-> (itm_eval recalls, path of results.bin); prints the recalls."""
    args = parse_with_config(build_parser(), cmds)
    print_args(args, LOGGER.info)
    setup_runtime(args)
    os.makedirs(args.output_dir, exist_ok=True)
    dtype = torch.bfloat16 if args.compute_dtype == "bf16" else torch.float32
    model = load_cross_encoder(args.checkpoint,
                               model_config=args.model_config,
                               compute_dtype=dtype, device=args.device)

    txt_db = TxtTokDb(args.txt_db, -1)
    img_db = DetectFeatDb(args.img_db, args.conf_th, args.max_bb,
                          args.min_bb, args.num_bb)
    txt2img, img2txts = txt_db.txt2img, txt_db.img2txts
    txt_ids = list(txt_db.ids)
    img_ids = sorted({txt2img[t] for t in txt_ids})
    tokens = [txt_db.combine_inputs(txt_db[t]["input_ids"]) for t in txt_ids]
    feats, poss = [], []
    for im in img_ids:
        f, p, _ = img_db.get_img_feat(im)
        feats.append(f)
        poss.append(p)

    scorer = CrossScorer(model, pair_block=args.batch_size,
                         device=args.device)
    LOGGER.info("scoring %d x %d pairs", len(txt_ids), len(img_ids))
    score_matrix = scorer.score_matrix(tokens, feats, poss)
    eval_log = itm_eval(score_matrix, txt_ids, img_ids, txt2img, img2txts)
    LOGGER.info("itm_eval: %s", eval_log)
    out = os.path.join(args.output_dir, "results.bin")
    with open(out, "wb") as f:
        pickle.dump((score_matrix, txt_ids, img_ids), f)
    LOGGER.info("wrote %s", out)
    print(json.dumps(eval_log, default=float))
    return eval_log, out


if __name__ == "__main__":
    main()
