"""The port's micro-batching front end and HTTP layer
(``lightningdot_tpu_torch.serving_frontend`` / ``serving_http``) on the
cases of tests/test_serving_frontend.py and tests/test_serving_http.py,
over the port's Retriever on the CPU. The JAX file's
``test_frontend_over_sharded_retriever`` needs the sharded corpus, which
is held in tests/test_torch_sharded.py."""
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.models import BiEncoder, init_tower_
from lightningdot_tpu_torch.serving import Retriever, ranking_equivalent
from lightningdot_tpu_torch.serving_frontend import BatchingFrontend
from lightningdot_tpu_torch.serving_http import RetrievalServer

TINY = dict(vocab_size=512, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


class Tok:
    """Deterministic word-hash tokenizer with BERT's special ids."""
    cls_token_id = 101

    def encode(self, text):
        return [101] + [200 + sum(map(ord, w)) % 50
                        for w in text.split()] + [102]


@pytest.fixture(scope="module")
def retriever():
    model = BiEncoder(EncoderConfig(**TINY))
    init_tower_(model.txt_model, torch.Generator().manual_seed(0))
    r = Retriever(model, Tok(), device="cpu")
    rng = np.random.default_rng(0)
    ids = [f"img_{i}" for i in range(200)]
    r.set_corpus(ids, rng.standard_normal((200, 32)).astype(np.float32))
    return r


# ---------------------------------------------------------------------------
# tests/test_serving_frontend.py
# ---------------------------------------------------------------------------

def test_results_match_direct_queries(retriever):
    queries = [f"query number {i} words {i % 3}" for i in range(10)]
    want = [retriever.retrieve_query(q, top=7) for q in queries]
    with BatchingFrontend(retriever, max_batch=4, max_wait_ms=5.0) as fe:
        got = fe.retrieve_many(queries, top=7)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        # another group size sums in another order against the bf16
        # corpus: scores agree at bf16 resolution, rankings exactly
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=2e-3)


def test_concurrent_submissions_coalesce(retriever):
    """A burst of concurrent callers is served in fewer device calls than
    requests, and every caller gets its own correct result."""
    n = 32
    with BatchingFrontend(retriever, max_batch=16, max_wait_ms=50.0) as fe:
        barrier = threading.Barrier(n)

        def call(i):
            barrier.wait()           # release the burst at once
            return i, fe.retrieve(f"dog {i}", top=5)

        with ThreadPoolExecutor(n) as pool:
            results = dict(pool.map(call, range(n)))
        assert fe.requests_served == n
        assert fe.batches_dispatched < n   # coalescing happened
    for i in range(n):
        want = retriever.retrieve_query(f"dog {i}", top=5)
        assert [x for x, _ in results[i]] == [x for x, _ in want]


def test_mixed_tops_slice_per_request(retriever):
    with BatchingFrontend(retriever, max_batch=8, max_wait_ms=50.0) as fe:
        f_small = fe.submit("a cat", top=3)
        f_large = fe.submit("a dog", top=20)
        assert len(f_small.result()) == 3
        assert len(f_large.result()) == 20
    want = retriever.retrieve_query("a cat", top=3)
    assert [i for i, _ in f_small.result()] == [i for i, _ in want]


def test_batch_bucket_padding(retriever):
    """Group sizes pad up the bucket ladder; results are still per-request
    correct."""
    fe = BatchingFrontend(retriever, max_batch=8, max_wait_ms=20.0,
                          batch_buckets=(4, 8))
    assert fe.batch_buckets == [4, 8]
    try:
        res = fe.retrieve("one lonely query", top=5)
        assert len(res) == 5
        want = retriever.retrieve_query("one lonely query", top=5)
        assert [i for i, _ in res] == [i for i, _ in want]
    finally:
        fe.close()


def test_close_rejects_new_and_drains(retriever):
    fe = BatchingFrontend(retriever, max_batch=4, max_wait_ms=1.0)
    fut = fe.submit("before close", top=5)
    fe.close()
    assert len(fut.result(timeout=10)) == 5
    with pytest.raises(RuntimeError):
        fe.submit("after close")


def test_dispatch_survives_errors(retriever):
    class Boom:
        def __init__(self, inner):
            self.inner = inner
            self.calls = 0

        def retrieve_batch(self, queries, top):
            self.calls += 1
            if self.calls == 1:
                raise ValueError("injected")
            return self.inner.retrieve_batch(queries, top=top)

    boom = Boom(retriever)
    with BatchingFrontend(boom, max_batch=4, max_wait_ms=1.0) as fe:
        f1 = fe.submit("first", top=5)
        with pytest.raises(ValueError):
            f1.result(timeout=10)
        # the dispatcher survived; later requests succeed
        assert len(fe.retrieve("second", top=5)) == 5


def test_warmup_runs_every_bucket(retriever):
    calls = []

    class Spy:
        def retrieve_batch(self, queries, top):
            calls.append(len(queries))
            return retriever.retrieve_batch(queries, top=top)

    fe = BatchingFrontend(Spy(), max_batch=4, batch_buckets=(1, 2, 4))
    try:
        fe.warmup(top=5)
        assert calls == [1, 2, 4]
    finally:
        fe.close()


def test_cancelled_future_does_not_kill_resolver(retriever):
    """A caller cancelling its future must not break result delivery for
    anyone else."""
    with BatchingFrontend(retriever, max_batch=4, max_wait_ms=30.0) as fe:
        doomed = fe.submit("will be cancelled", top=5)
        doomed.cancel()
        ok = fe.submit("still served", top=5)
        assert len(ok.result(timeout=10)) == 5
        assert len(fe.retrieve("after the cancel", top=5)) == 5
        assert fe._resolver.is_alive()


def test_ranking_equivalent_tie_semantics():
    """The JAX case on the port's ``ranking_equivalent``, which takes no
    default atol: the last case states the 1e-1 that the JAX function
    derives from scores of order 100."""
    want = [("a", 0.90), ("b", 0.800), ("c", 0.7995), ("d", 0.60)]
    assert ranking_equivalent(list(want), want, atol=1e-3)[0]
    got = [("a", 0.90), ("c", 0.7996), ("b", 0.7999), ("d", 0.60)]
    assert ranking_equivalent(got, want, atol=1e-3)[0]
    got = [("a", 0.90), ("b", 0.800), ("c", 0.7995), ("e", 0.6002)]
    assert ranking_equivalent(got, want, atol=1e-3)[0]
    got = [("d", 0.90), ("b", 0.800), ("c", 0.7995), ("a", 0.60)]
    ok, why = ranking_equivalent(got, want, atol=1e-3)
    assert not ok and "score" in why
    got = [("a", 0.90), ("c", 0.800), ("b", 0.7995), ("d", 0.60)]
    ok, why = ranking_equivalent(got, want, atol=1e-4)
    assert not ok
    got = [("a", 0.90), ("b", 0.800), ("x", 0.7995), ("d", 0.60)]
    ok, why = ranking_equivalent(got, want, atol=1e-4)
    assert not ok and "boundary" in why
    assert not ranking_equivalent(want[:3], want, atol=1e-3)[0]
    big_w = [("a", 100.0), ("b", 99.99)]
    big_g = [("b", 99.992), ("a", 99.998)]
    assert ranking_equivalent(big_g, big_w, atol=1e-1)[0]
    with pytest.raises(TypeError):
        ranking_equivalent(big_g, big_w)


# ---------------------------------------------------------------------------
# tests/test_serving_http.py
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read())


@pytest.fixture()
def server(retriever):
    fe = BatchingFrontend(retriever, max_batch=8, max_wait_ms=5.0)
    with RetrievalServer(fe, port=0) as srv:
        yield srv


def test_search_and_health(server):
    status, body = _get(f"{server.address}/healthz")
    assert status == 200 and body["ok"] and body["corpus"] == 200

    status, body = _get(f"{server.address}/search?q=a+dog&top=5")
    assert status == 200
    assert body["query"] == "a dog"
    assert len(body["results"]) == 5
    scores = [s for _, s in body["results"]]
    assert scores == sorted(scores, reverse=True)
    want = server.frontend.retriever.retrieve_query("a dog", top=5)
    assert [i for i, _ in want] == [i for i, _ in body["results"]]


def test_concurrent_http_requests_coalesce(server):
    urls = [f"{server.address}/search?q=dog+{i}&top=3" for i in range(16)]
    with ThreadPoolExecutor(16) as pool:
        out = list(pool.map(_get, urls))
    assert all(status == 200 and len(body["results"]) == 3
               for status, body in out)
    fe = server.frontend
    assert fe.requests_served >= 16
    assert fe.batches_dispatched < fe.requests_served  # coalescing happened


def test_error_codes(server):
    # top outside [1, max_top] must 400 before reaching the device
    for path, code in [("/nope", 404), ("/search", 400),
                       ("/search?q=x&top=abc", 400),
                       ("/search?q=x&top=0", 400),
                       ("/search?q=x&top=-1", 400),
                       ("/search?q=x&top=101", 400)]:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{server.address}{path}")
        assert ei.value.code == code


def test_submit_rejects_bad_top(retriever):
    with BatchingFrontend(retriever, max_batch=4, max_wait_ms=1.0,
                          max_top=50) as fe:
        with pytest.raises(ValueError):
            fe.submit("q", top=0)
        with pytest.raises(ValueError):
            fe.submit("q", top=51)
        assert len(fe.retrieve("q", top=50)) == 50
