"""Retrieval demo on the PyTorch/CUDA port (the counterpart of
demo_retrieval.py, which runs the JAX package).

End to end on synthetic data, with nothing downloaded:
  1. build a synthetic image/caption corpus (``data/synth.py``),
  2. encode its images once with the bi-encoder
     (``get_model_encoded_vecs``),
  3. serve free-text queries from the corpus held on the device
     (``Retriever``), tokenized by a WordPiece vocabulary that
     ``synth_wordpiece_vocab`` writes in BERT-base cased's size.

    python examples/demo_retrieval_torch.py              # on the card
    python examples/demo_retrieval_torch.py --device cpu

With real data, point ``TxtTokDb``/``DetectFeatDb`` at prepared DBs
(``cli/prepro.py``), use BERT's ``vocab.txt``, and load released weights
with ``models.factory.build_biencoder(args)`` and
``--biencoder_checkpoint``.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.itm import (CollateConfig, ItmFastDataset,
                                            itm_fast_collate)
from lightningdot_tpu_torch.data.loader import DataLoader
from lightningdot_tpu_torch.data.synth import (make_synth_dataset,
                                              synth_wordpiece_vocab)
from lightningdot_tpu_torch.data.tokenizer import WordPieceTokenizer
from lightningdot_tpu_torch.data.txt_db import TxtTokDb
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.models import BiEncoder, init_tower_
from lightningdot_tpu_torch.serving import Retriever, get_model_encoded_vecs

QUERIES = ["a dog running on the beach", "two people talking at a cafe"]
# BERT-base cased and UNITER-base's region features
TXT_CONFIG = dict(vocab_size=28996)
IMG_CONFIG = dict(vocab_size=28996, img_dim=2048)


def build(workdir, *, device=None, n_imgs=64, txt_config=TXT_CONFIG,
          img_config=IMG_CONFIG, compute_dtype=torch.bfloat16, seed=0):
    """The corpus of ``n_imgs`` synthetic images (2 captions each) under
    ``workdir``, encoded once by a bi-encoder with random weights from
    ``seed``, in a ``Retriever`` on ``device`` (None: the card)."""
    device = resolve_device(device)
    txt_dir, img_dir = make_synth_dataset(
        os.path.join(workdir, "data"), n_imgs=n_imgs, txts_per_img=2,
        img_dim=img_config.get("img_dim", 2048), seed=seed)
    vocab = os.path.join(workdir, "vocab.txt")
    synth_wordpiece_vocab(vocab, seed=seed)
    tokenizer = WordPieceTokenizer(vocab)

    # random weights here; load a checkpoint for real use
    model = BiEncoder(EncoderConfig(**txt_config),
                      EncoderConfig(**img_config),
                      compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(seed)
    init_tower_(model.txt_model, gen)
    init_tower_(model.img_model, gen)

    ds = ItmFastDataset(TxtTokDb(txt_dir, -1), DetectFeatDb(img_dir))
    ds.new_epoch()
    loader = DataLoader(ds, batch_size=32, collate_fn=lambda x:
                        itm_fast_collate(x, CollateConfig(fixed_batch=32)))
    vecs = get_model_encoded_vecs(model, loader, device=device)
    img_ids = list(vecs["img_embed"].keys())
    corpus = np.stack([vecs["img_embed"][i] for i in img_ids])
    retriever = Retriever(model, tokenizer, device=device)
    retriever.set_corpus(img_ids, corpus)
    return retriever


def main(argv=None, **build_kw):
    """Build the demo and answer ``QUERIES``; returns {query: top 5}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch path")
    ap.add_argument("--n_imgs", type=int, default=64)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as workdir:
        retriever = build(workdir, device=args.device, n_imgs=args.n_imgs,
                          **build_kw)
        print(f"encoded corpus: {retriever.corpus_size} images on "
              f"{retriever.device}")
        out = {}
        for query in QUERIES:
            out[query] = retriever.retrieve_query(query, top=5)
            print(f"\nquery: {query!r}")
            for rank, (img, score) in enumerate(out[query], 1):
                print(f"  {rank}. {img}  (score {score:.3f})")
    return out


if __name__ == "__main__":
    main()
