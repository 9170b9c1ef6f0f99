"""Retrieval evaluation driver (the port's ``eval_itm``,
lightningdot_tpu/cli/eval_itm.py:28-111; reference eval_itm.py): load the
config and checkpoint, build the val/test ItmFast datasets, run
``eval_model_on_dataloader`` and report recall@{1,5,10} in both
directions.

It runs on the card by default, or on the CPU with ``--device cpu``.
Caption blending (``--itm_global_file``) tokenizes the captions with the
port's own WordPiece tokenizer over a local ``--vocab_file``, where the
JAX CLI loads ``bert-base-cased`` by name (a download). The JAX CLI's
``setup_runtime`` (its TPU compile cache) has no counterpart: the port's
kernels are built once per checkout (``ops/_build.py``).

Usage (reference-compatible config JSONs):
  python -m lightningdot_tpu_torch.cli.eval_itm \\
      --config configs/coco_eval.json --vocab_file /path/vocab.txt \\
      --biencoder_checkpoint /path/LightningDot.pt
"""
from __future__ import annotations

import argparse
import json
import time

from lightningdot_tpu_torch.config import (add_itm_params, default_params,
                                           parse_with_config, print_args)
from lightningdot_tpu_torch.data.feat_db import ImageDbGroup
from lightningdot_tpu_torch.data.itm import CollateConfig, itm_fast_collate
from lightningdot_tpu_torch.models.factory import build_biencoder
from lightningdot_tpu_torch.training.evaluator import eval_model_on_dataloader
from lightningdot_tpu_torch.training.trainer_utils import (build_dataloader,
                                                           load_dataset)
from lightningdot_tpu_torch.utils.logging import LOGGER


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("eval_itm", allow_abbrev=False)
    default_params(parser)
    add_itm_params(parser)
    parser.add_argument("--vocab_file", default=None, type=str,
                        help="WordPiece vocab.txt for caption blending "
                             "(--itm_global_file)")
    parser.add_argument("--device", default=None, type=str,
                        help="default: the CUDA card (raises without "
                             "one); 'cpu' runs the plain PyTorch path")
    return parser


def _load_caption_meta(args) -> None:
    """Populate img_meta_dict + tokenizer from --itm_global_file so the
    caption-blending path gets its caps (reference eval_itm.py:54,86-90;
    JAX CLI eval_itm.py:39-49)."""
    args.img_meta_dict = getattr(args, "img_meta_dict", None)
    args.tokenizer = getattr(args, "tokenizer", None)
    if getattr(args, "itm_global_file", None) and args.img_meta_dict is None:
        if not getattr(args, "vocab_file", None):
            raise ValueError("--itm_global_file (caption blending) needs "
                             "--vocab_file, the WordPiece vocab.txt")
        from lightningdot_tpu_torch.data.tokenizer import WordPieceTokenizer

        with open(args.itm_global_file) as f:
            args.img_meta_dict = json.load(f)
        args.tokenizer = WordPieceTokenizer(args.vocab_file,
                                            do_lower_case=False)


def evaluate(args, split: str = "test", model=None):
    """EVAL_MODEL equivalent (eval_itm.py:52-86)."""
    _load_caption_meta(args)
    if model is None:
        model = build_biencoder(args, seed=args.seed)

    all_img_dbs = ImageDbGroup(args.conf_th, args.max_bb, args.min_bb,
                               args.num_bb)
    txt_db = args.test_txt_db if split == "test" else args.val_txt_db
    img_db = args.test_img_db if split == "test" else args.val_img_db
    dataset = load_dataset(all_img_dbs, txt_db, img_db, args, is_train=False)
    dataset.new_epoch()
    img2txt = dataset.txt_db.img2txts

    collate = lambda items: itm_fast_collate(  # noqa: E731
        items, CollateConfig(fixed_batch=args.valid_batch_size))
    loader = build_dataloader(dataset, collate, False, args)

    t0 = time.time()
    result = eval_model_on_dataloader(
        model, loader, img2txt=img2txt,
        vector_size=model.txt_cfg.out_size,
        caption_score_weight=args.caption_score_weight,
        hnsw=args.hnsw_index, device=getattr(args, "device", None))
    LOGGER.info("eval %s: time cost = %.1fs", split, time.time() - t0)
    recall_txt, recall_img = result.recall
    LOGGER.info("%s: loss=%.4f correct_ratio=%.4f", split, result.loss,
                result.correct_ratio)
    LOGGER.info("txt->img (image retrieval) recall: %s", recall_txt)
    LOGGER.info("img->txt (text retrieval) recall: %s", recall_img)
    return result


def main(cmds=None):
    args = parse_with_config(build_parser(), cmds)
    print_args(args, LOGGER.info)
    # build once for both splits
    model = build_biencoder(args, seed=args.seed)
    results = {}
    for split in ("val", "test"):
        txt_db = args.test_txt_db if split == "test" else args.val_txt_db
        if not txt_db:
            continue
        res = evaluate(args, split, model=model)
        results[split] = {
            "loss": res.loss,
            "correct_ratio": res.correct_ratio,
            "recall_txt": res.recall[0],
            "recall_img": res.recall[1],
        }
    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
