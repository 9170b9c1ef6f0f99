"""Serve text-to-image retrieval over HTTP on the PyTorch/CUDA port (the
counterpart of serve_http.py, which runs the JAX package).

Runs on synthetic data with nothing downloaded: a bi-encoder with random
weights, a corpus of random vectors held on the device, and a WordPiece
vocabulary that ``synth_wordpiece_vocab`` writes in BERT-base cased's
size. With real data, load released weights through
``models.factory.build_biencoder`` and a real corpus through
``Retriever.load_corpus`` or ``get_model_encoded_vecs``, and use BERT's
``vocab.txt``.

    python examples/serve_http_torch.py [--port 8080] [--device cpu]
    curl 'http://127.0.0.1:8080/search?q=two+dogs+play&top=5'

Concurrent clients coalesce into batched device calls
(``BatchingFrontend``); the device calls are serialized.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.data.synth import synth_wordpiece_vocab
from lightningdot_tpu_torch.data.tokenizer import WordPieceTokenizer
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.models import BiEncoder, init_tower_
from lightningdot_tpu_torch.serving import Retriever
from lightningdot_tpu_torch.serving_frontend import BatchingFrontend
from lightningdot_tpu_torch.serving_http import RetrievalServer

# BERT-base cased with its 768-wide output as the corpus vectors' width
CONFIG = dict(vocab_size=28996, project_dim=0)


def build(workdir, *, device=None, corpus=20_000, config=CONFIG,
          compute_dtype=torch.bfloat16, seed=0):
    """A ``BatchingFrontend`` over a ``Retriever`` on ``device`` (None: the
    card): the text tower with random weights from ``seed``, a corpus of
    ``corpus`` random vectors, the vocabulary written under ``workdir``."""
    device = resolve_device(device)
    vocab = os.path.join(workdir, "vocab.txt")
    synth_wordpiece_vocab(vocab, seed=seed)
    cfg = EncoderConfig(**config)
    model = BiEncoder(cfg, compute_dtype=compute_dtype)
    init_tower_(model.txt_model, torch.Generator().manual_seed(seed))
    retriever = Retriever(model, WordPieceTokenizer(vocab), device=device)
    rng = np.random.default_rng(seed)
    retriever.set_corpus([f"img_{i:08d}" for i in range(corpus)],
                         rng.standard_normal((corpus, cfg.out_size),
                                             dtype=np.float32))
    frontend = BatchingFrontend(retriever, max_batch=64, max_wait_ms=2.0)
    frontend.warmup(top=frontend.max_top)
    return frontend


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch path")
    ap.add_argument("--corpus", type=int, default=20_000,
                    help="random corpus vectors")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as workdir:
        frontend = build(workdir, device=args.device, corpus=args.corpus)
        with RetrievalServer(frontend, host=args.host,
                             port=args.port) as srv:
            print(f"serving on {srv.address}  (Ctrl-C to stop)")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                pass


if __name__ == "__main__":
    main()
