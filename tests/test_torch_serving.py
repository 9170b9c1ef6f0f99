"""The port's Retriever (lightningdot_tpu_torch.serving) against the JAX
package's, on the same weights, and behind the native server (both
packages' copies) and the port's HTTP front end.

Model: ``tiny_biencoder`` of tests/test_serving.py (float32), its JAX
weights carried to the port with ``tower_state_dict_from_jax``. Rankings
are compared with ``ranking_equivalent`` at atol 1e-3 on scores of order
10-20: float32 on both sides, where only the summation order differs
(about 1e-5 relative after two layers). The servers print scores with four
decimals, inside that band.
"""
import importlib
import json
import subprocess
import sys
import threading
import urllib.request
from urllib.parse import quote

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu import serving as jserving
from lightningdot_tpu.config import EncoderConfig
from lightningdot_tpu.models.bi_encoder import BiEncoder as JBiEncoder
from lightningdot_tpu_torch.models import (BiEncoder, load_tower_,
                                           tower_state_dict_from_jax)
from lightningdot_tpu_torch.ops import launch_counts
from lightningdot_tpu_torch.serving import Retriever, ranking_equivalent

TINY = dict(vocab_size=512, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
ATOL = 1e-3
N_CORPUS = 300


class Tok:
    """Deterministic word-hash tokenizer with BERT's special ids."""
    cls_token_id = 101

    def encode(self, text):
        return [101] + [200 + sum(map(ord, w)) % 300
                        for w in text.split()] + [102]


@pytest.fixture(scope="module")
def setup():
    cfg = EncoderConfig(**TINY)
    jmodel = JBiEncoder(cfg, EncoderConfig(**TINY, img_dim=16),
                        compute_dtype=jnp.float32)
    # noise of std 0.2 on every weight: at its own init scale a tower this
    # small gives nearly the same embedding (cosine ~1) for every query
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape)
                   ).astype(np.float32), jmodel.init(jax.random.PRNGKey(0)))
    model = BiEncoder(cfg)
    load_tower_(model.txt_model, tower_state_dict_from_jax(
        jax.tree.map(np.asarray, params["txt_model"])))
    ids = [f"img_{i}" for i in range(N_CORPUS)]
    vecs = np.random.default_rng(0).standard_normal(
        (N_CORPUS, 32)).astype(np.float32)
    port = Retriever(model, Tok(), device="cpu")
    port.set_corpus(ids, vecs)
    ref = jserving.Retriever(jmodel, params, Tok())
    ref.set_corpus(ids, vecs)
    return {"cfg": cfg, "model": model, "port": port, "ref": ref,
            "ids": ids, "vecs": vecs}


def _queries(n, words, seed):
    rng = np.random.default_rng(seed)
    vocab = ["dog", "cat", "beach", "red", "car", "man", "tree", "two",
             "sitting", "on", "a", "the", "with", "green", "field"]
    return [" ".join(rng.choice(vocab, words)) for _ in range(n)]


def _equivalent(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        ok, why = ranking_equivalent(g, w, atol=atol)
        assert ok, why


@pytest.mark.parametrize("words", [5, 20, 50])    # length buckets 16/32/64
@pytest.mark.parametrize("n", [1, 3, 9])          # batch buckets 1/4/16
def test_rankings_match_jax_retriever(setup, n, words):
    queries = _queries(n, words, seed=n * 100 + words)
    _equivalent(setup["port"].retrieve_batch(queries, top=10),
                setup["ref"].retrieve_batch(queries, top=10))


def test_corpus_files_load_in_either_package(setup, tmp_path):
    port, ref = setup["port"], setup["ref"]
    queries = _queries(2, 6, seed=1)
    want = port.retrieve_batch(queries, top=10)

    ref.save_corpus(str(tmp_path / "from_jax"))
    other = Retriever(setup["model"], Tok(), device="cpu")
    other.load_corpus(str(tmp_path / "from_jax"))
    assert other.ids == setup["ids"] and other.corpus_size == N_CORPUS
    assert torch.equal(other._corpus, port._corpus)
    _equivalent(other.retrieve_batch(queries, top=10), want)

    port.save_corpus(str(tmp_path / "from_port"))
    ref2 = jserving.Retriever(ref.model, ref.params, Tok())
    ref2.load_corpus(str(tmp_path / "from_port"))
    np.testing.assert_array_equal(np.asarray(ref2._corpus, np.float32),
                                  np.asarray(ref._corpus, np.float32))
    _equivalent(ref2.retrieve_batch(queries, top=10), want)


def test_planted_query_embeddings_rank_first(setup):
    """bfloat16 serving: each query's own embedding, planted in the corpus,
    must rank first."""
    model = BiEncoder(setup["cfg"], compute_dtype=torch.bfloat16)
    model.load_state_dict(setup["model"].state_dict())
    r = Retriever(model, Tok(), device="cpu")
    queries = _queries(4, 7, seed=2)
    r.set_corpus(setup["ids"], setup["vecs"])
    planted = r.encode_queries(queries)
    assert planted.shape == (4, 32) and np.isfinite(planted).all()
    r.set_corpus(setup["ids"] + [f"planted_{i}" for i in range(4)],
                 np.concatenate([setup["vecs"], planted]))
    for i, res in enumerate(r.retrieve_batch(queries, top=3)):
        assert res[0][0] == f"planted_{i}"


def test_padding_rows_and_batch_buckets(setup):
    port = setup["port"]
    queries = _queries(7, 6, seed=3)
    singles = [port.retrieve_query(q, top=5) for q in queries]
    _equivalent(port.retrieve_batch(queries, top=5), singles)
    assert port._batch_bucket(9) == 16 and port._batch_bucket(300) == 512

    class NoCls:
        def encode(self, text):
            return [7] + [200 + len(w) for w in text.split()]

    no_cls = Retriever(setup["model"], NoCls(), device="cpu")
    assert no_cls._pad_token([[7, 3]]) == 7
    assert port._pad_token([[5, 3]]) == 101

    class OutOfVocab:
        def encode(self, text):
            return [101, 100000]

    bad = Retriever(setup["model"], OutOfVocab(), device="cpu")
    bad.set_corpus(setup["ids"], setup["vecs"])
    with pytest.raises(ValueError, match="vocabulary"):
        bad.retrieve_query("x")


def test_options_of_later_slices_raise(setup):
    """The int8 and approximate options (ported since) are accepted and
    serve; unknown values of each option raise."""
    queries = _queries(3, 6, seed=6)
    for kw in ({"quantization": "int8"}, {"weight_quantization": "int8"},
               {"topk": "approx", "topk_recall": 0.9}):
        r = Retriever(setup["model"], Tok(), device="cpu", **kw)
        r.set_corpus(setup["ids"], setup["vecs"])
        res = r.retrieve_batch(queries, top=5)
        assert [len(x) for x in res] == [5, 5, 5]
        assert all(s1 >= s2 for x in res for (_, s1), (_, s2)
                   in zip(x, x[1:]))
    for kw in ({"topk": "nope"}, {"quantization": "int4"},
               {"weight_quantization": "fp8"}):
        with pytest.raises(ValueError):
            Retriever(setup["model"], Tok(), device="cpu", **kw)


def test_ranking_equivalent_rules():
    want = [("a", 3.0), ("b", 2.0), ("c", 1.0)]
    assert ranking_equivalent(want, want, atol=1e-6)[0]
    # a swap inside the tie band, and a boundary tie swapping in
    assert ranking_equivalent([("b", 2.0), ("a", 2.0), ("c", 1.0)],
                              [("a", 2.0), ("b", 2.0), ("c", 1.0)],
                              atol=1e-6)[0]
    assert ranking_equivalent([("a", 3.0), ("b", 2.0), ("d", 1.0)],
                              want, atol=1e-6)[0]
    # a real divergence, and a duplicated id
    assert not ranking_equivalent([("a", 3.0), ("c", 2.0), ("b", 1.0)],
                                  want, atol=1e-6)[0]
    ok, why = ranking_equivalent([("a", 3.0), ("a", 2.0), ("c", 1.0)],
                                 [("a", 3.0), ("x", 2.0), ("c", 1.0)],
                                 atol=1.5)
    assert not ok and "duplicate" in why


def _get(address, query, top):
    url = f"{address}/search?q={quote(query)}&top={top}"
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _serve_and_check(address, retriever, n=12, top=5):
    queries = _queries(n, 4, seed=4)
    out = [None] * n

    def call(i):
        out[i] = _get(address, queries[i], top)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    want = retriever.retrieve_batch(queries, top=top)
    _equivalent([[tuple(x) for x in o["results"]] for o in out], want)


@pytest.mark.parametrize("package", ["lightningdot_tpu",
                                     "lightningdot_tpu_torch"])
def test_native_server_serves_the_port_retriever(setup, package):
    """The JAX package's native server and the port's own copy of it."""
    serve_retriever = importlib.import_module(
        f"{package}.serving_native").serve_retriever
    port = setup["port"]
    srv = serve_retriever(port, max_batch=8, max_top=10)
    try:
        _serve_and_check(srv.address, port)
        assert srv.stats()["errors"] == 0
    finally:
        srv.stop()


def test_http_server_serves_the_port_retriever(setup):
    from lightningdot_tpu_torch.serving_frontend import BatchingFrontend
    from lightningdot_tpu_torch.serving_http import RetrievalServer

    port = setup["port"]
    with RetrievalServer(BatchingFrontend(port, max_batch=8,
                                          max_top=10)) as srv:
        _serve_and_check(srv.address, port)


def test_launch_counters_stay_zero_on_cpu(setup):
    setup["port"].retrieve_batch(_queries(3, 5, seed=5), top=4)
    assert launch_counts() == {"layernorm": 0, "layernorm_bwd": 0,
                               "attention": 0, "ffn": 0,
                               "ffn_mma": 0, "ffn_int8": 0, "ffn_dh1": 0,
                               "ffn_dh1_mma": 0,
                               "adamw": 0, "attention_train_fwd": 0,
                               "attention_train_bwd": 0,
                               "attention_train_bwd_mma": 0,
                               "rmsnorm": 0, "rmsnorm_bwd": 0,
                               "mla_attention": 0, "mla_attention_bwd": 0,
                               "rope": 0, "moe_gemm": 0, "moe_combine": 0,
                               "moe_scatter_rows": 0, "moe_route_grad": 0}


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import lightningdot_tpu_torch as p\n"
            "import lightningdot_tpu_torch.serving, "
            "lightningdot_tpu_torch.models, lightningdot_tpu_torch.ops\n"
            "p.Retriever\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
