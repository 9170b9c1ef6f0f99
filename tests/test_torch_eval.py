"""The port's evaluation slice (ROADMAP A6) against the JAX package: the
metrics, the flat and HNSW indexes, the in-batch loss, the readers and the
ITM dataset, the sampler and loader, the Recycler, the evaluator and the
``eval_itm`` CLI, on the same seeded inputs.

Tolerances: the metrics, the HNSW results (one native library), the
readers, the items and the sampler's batches are held exactly; the flat
index's ids exactly and its float32 scores within 1e-5; the loss within
1e-6 in float32; the evaluator's recall dicts exactly, its loss and
correct ratio within 1e-5 (float32 on both sides, where only summation
orders differ). Small models: 2 layers, hidden 32, ``img_dim`` 64, as
tests/test_eval_e2e.py.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu import config as jconfig
from lightningdot_tpu.data import feat_db as jfeat_db
from lightningdot_tpu.data import itm as jitm
from lightningdot_tpu.data import kvstore as jkv
from lightningdot_tpu.data import loader as jloader
from lightningdot_tpu.data import txt_db as jtxt_db
from lightningdot_tpu.data.synth import make_synth_dataset
from lightningdot_tpu.index import DenseFlatIndex as JFlat
from lightningdot_tpu.index.hnsw import DenseHNSWFlatIndexer as JHNSW
from lightningdot_tpu.models import bi_encoder as jbi
from lightningdot_tpu.models import factory as jfactory
from lightningdot_tpu.training import evaluator as jevaluator
from lightningdot_tpu.training import trainer_utils as jtrainer_utils
from lightningdot_tpu.utils import metrics as jmetrics
from lightningdot_tpu_torch import config
from lightningdot_tpu_torch.data import feat_db, itm, kvstore, loader
from lightningdot_tpu_torch.data import padding, txt_db
from lightningdot_tpu_torch.index import DenseFlatIndex, DenseHNSWFlatIndexer
from lightningdot_tpu_torch.models import (BiEncoder, BiEncoderNllLoss,
                                           load_tower_,
                                           tower_state_dict_from_jax)
from lightningdot_tpu_torch.models import factory
from lightningdot_tpu_torch.training import evaluator, trainer_utils
from lightningdot_tpu_torch.utils import metrics

SMALL = dict(vocab_size=28996, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return make_synth_dataset(str(root), n_imgs=12, txts_per_img=2,
                              img_dim=64, min_bb=5, max_bb=20,
                              max_txt_len=30)


def _same(got, want):
    """Deep equality of items and batches (arrays by dtype and value)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    n_img, per = 9, 3
    img_ids = [f"im{i}" for i in range(n_img)]
    txt_ids = [f"t{i}_{j}" for i in range(n_img) for j in range(per)]
    txt2img = {t: t.split("_")[0].replace("t", "im") for t in txt_ids}
    img2txts = {i: [t for t in txt_ids if txt2img[t] == i] for i in img_ids}
    scores = rng.standard_normal((len(txt_ids), n_img))
    assert metrics.itm_eval(scores, txt_ids, img_ids, txt2img, img2txts) == \
        jmetrics.itm_eval(scores, txt_ids, img_ids, txt2img, img2txts)
    ranked_t = {t: list(rng.permutation(img_ids)) for t in txt_ids}
    queries = txt_ids + txt_ids[:4]          # duplicates counted as given
    assert metrics.recall_from_ranked_ids(queries, ranked_t, txt2img) == \
        jmetrics.recall_from_ranked_ids(queries, ranked_t, txt2img)
    ranked_i = {i: list(rng.permutation(txt_ids)) for i in img_ids}
    queries = img_ids + img_ids[::2]         # deduplicated
    assert metrics.recall_any_from_ranked_ids(queries, ranked_i,
                                              img2txts) == \
        jmetrics.recall_any_from_ranked_ids(queries, ranked_i, img2txts)


# ---------------------------------------------------------------------------
# the flat index and HNSW
# ---------------------------------------------------------------------------

def _corpus(rng, n, d=32):
    return ([f"img_{i}" for i in range(n)],
            rng.standard_normal((n, d)).astype(np.float32))


def _hold_search(got, want):
    assert len(got) == len(want)
    for (g_ids, g_sc), (w_ids, w_sc) in zip(got, want):
        assert g_ids == w_ids
        np.testing.assert_allclose(np.asarray(g_sc), np.asarray(w_sc),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,k", [(1000, 10), (301, 5), (130, 130)])
def test_flat_index_matches_jax(n, k):
    rng = np.random.default_rng(n)
    ids, vecs = _corpus(rng, n)
    q = rng.standard_normal((17, 32)).astype(np.float32)
    got = DenseFlatIndex(32, device="cpu")
    got.index_data(list(zip(ids[:100], vecs[:100])))
    got.index_data(list(zip(ids[100:], vecs[100:])))
    want = JFlat(32)
    want.index_data(list(zip(ids, vecs)))
    assert got.ntotal == want.ntotal == n
    _hold_search(got.search_knn(q, k), want.search_knn(q, k))
    # one query as a vector, and k above the corpus
    _hold_search(got.search_knn(q[0], n + 5), want.search_knn(q[0], n + 5))


def test_flat_index_never_returns_padding():
    rng = np.random.default_rng(3)
    ids, vecs = _corpus(rng, 130)
    vecs = -np.abs(vecs) - 1.0
    q = np.abs(rng.standard_normal((2, 32))).astype(np.float32)
    index = DenseFlatIndex(32, device="cpu")
    index.index_data(list(zip(ids, vecs)))
    for got_ids, got_scores in index.search_knn(q, 10):
        assert len(got_ids) == 10 and set(got_ids) <= set(ids)
        assert (np.asarray(got_scores) < 0).all()


def test_flat_index_chunked_equals_unchunked():
    """The streaming top-k (chunks of 256 over a corpus padded to 1,024)
    returns what one product over the whole corpus returns, and what the
    JAX package's chunked path returns."""
    rng = np.random.default_rng(4)
    ids, vecs = _corpus(rng, 1000)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    chunked = DenseFlatIndex(32, device="cpu")
    chunked.SCORE_BUDGET, chunked.CORPUS_CHUNK = 8192 * 64, 256
    plain = DenseFlatIndex(32, device="cpu")
    jchunked = JFlat(32)
    jchunked.SCORE_BUDGET, jchunked.CORPUS_CHUNK = 8192 * 64, 256
    for index in (chunked, plain, jchunked):
        index.index_data(list(zip(ids, vecs)))
    calls = []
    real = chunked._search_block
    chunked._search_block = lambda qb, k: calls.append(1) or real(qb, k)
    got = chunked.search_knn(q, 20)
    assert chunked._corpus.shape[0] == 1024 and calls
    from lightningdot_tpu_torch.index import dense

    qt = torch.from_numpy(q)
    s_c, i_c = dense._topk_scores_chunked(qt, chunked._corpus,
                                          chunked._pad_bias, 20, 256)
    s_p, i_p = dense._topk_scores(qt, chunked._corpus, chunked._pad_bias, 20)
    assert torch.equal(i_c, i_p)
    torch.testing.assert_close(s_c, s_p, rtol=0, atol=1e-5)
    _hold_search(got, plain.search_knn(q, 20))
    _hold_search(got, jchunked.search_knn(q, 20))


def test_flat_index_files_read_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    ids, vecs = _corpus(rng, 200)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    port = DenseFlatIndex(32, device="cpu")
    port.index_data(list(zip(ids, vecs)))
    port.serialize(str(tmp_path / "port"))
    jax_side = JFlat(32)
    jax_side.deserialize_from(str(tmp_path / "port"))
    _hold_search(jax_side.search_knn(q, 7), port.search_knn(q, 7))
    jax_side.serialize(str(tmp_path / "jax"))
    back = DenseFlatIndex(32, device="cpu")
    back.deserialize_from(str(tmp_path / "jax"))
    assert back.index_id_to_db_id == ids
    _hold_search(back.search_knn(q, 7), port.search_knn(q, 7))


def test_flat_index_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseFlatIndex(32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluator.build_index(32)


@pytest.mark.cuda
def test_flat_index_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(6)
    ids, vecs = _corpus(rng, 40_000, 64)
    q = rng.standard_normal((300, 64)).astype(np.float32)
    card, cpu = DenseFlatIndex(64), DenseFlatIndex(64, device="cpu")
    for index in (card, cpu):
        index.index_data(list(zip(ids, vecs)))
    _hold_search(card.search_knn(q, 100), cpu.search_knn(q, 100))


def test_hnsw_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    ids, vecs = _corpus(rng, 400)
    q = rng.standard_normal((20, 32)).astype(np.float32)
    got, want = DenseHNSWFlatIndexer(32), JHNSW(32)
    got.index_data(list(zip(ids, vecs)))
    want.index_data(list(zip(ids, vecs)))
    assert got.ntotal == want.ntotal == 400 and got.phi == want.phi
    res_g, res_w = got.search_knn(q, 10), want.search_knn(q, 10)
    for (gi, gs), (wi, ws) in zip(res_g, res_w):
        assert gi == wi
        np.testing.assert_array_equal(gs, ws)
    # each reads the other's files
    got.serialize(str(tmp_path / "port"))
    other = JHNSW(32)
    other.deserialize_from(str(tmp_path / "port"))
    assert [r[0] for r in other.search_knn(q, 10)] == [r[0] for r in res_g]
    with pytest.raises(RuntimeError, match="all data at once"):
        got.index_data(list(zip(ids[:2], vecs[:2])))


# ---------------------------------------------------------------------------
# the in-batch loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("captions", [False, True])
@pytest.mark.parametrize("col_valid", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_nll_loss_matches_jax(captions, col_valid, reduction):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    ctx = rng.standard_normal((9, 16)).astype(np.float32)
    cap = rng.standard_normal((9, 16)).astype(np.float32) if captions \
        else None
    pos = np.array([0, 1, 2, 3, 4, 8])
    valid = np.array([1, 1, 0, 1, 0, 1, 1, 0, 1], np.float32) \
        if col_valid else None
    got = BiEncoderNllLoss.calc(
        torch.from_numpy(q), torch.from_numpy(ctx),
        None if cap is None else torch.from_numpy(cap), pos, None, 0.3,
        reduction=reduction, col_valid=valid)
    want = jbi.BiEncoderNllLoss.calc(
        jnp.asarray(q), jnp.asarray(ctx),
        None if cap is None else jnp.asarray(cap), pos, None, 0.3,
        reduction=reduction, col_valid=valid)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    assert int(got[1]) == int(want[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# readers, writers, the dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_kvstore_reads_across_packages(tmp_path, native):
    items = [(f"k{i}", bytes(np.random.default_rng(i).integers(
        0, 255, i * 7 % 50, dtype=np.uint8))) for i in range(40)]
    items.append(("k3", b"last wins"))
    kvstore.KVWriter.write_dict(str(tmp_path / "port.ldkv"), items)
    jkv.KVWriter.write_dict(str(tmp_path / "jax.ldkv"), items)
    assert (tmp_path / "port.ldkv").read_bytes() == \
        (tmp_path / "jax.ldkv").read_bytes()
    for path in ("port.ldkv", "jax.ldkv"):
        got = kvstore.KVReader(str(tmp_path / path), prefer_native=native)
        want = jkv.KVReader(str(tmp_path / path), prefer_native=native)
        assert got.native == native
        assert len(got) == len(want) == 40
        assert sorted(got.keys()) == sorted(want.keys())
        for k in want.keys():
            assert bytes(got[k]) == bytes(want[k])
        assert got.get("missing") is None and "k3" in got


@pytest.mark.parametrize("fmt", ["raw", "npz"])
def test_feat_and_txt_dbs_read_across_packages(tmp_path, fmt):
    rng = np.random.default_rng(9)
    records = {}
    for i in range(6):
        nbb = int(rng.integers(5, 20))
        records[f"im{i}.npz"] = {
            "features": rng.standard_normal((nbb, 64)).astype(np.float16),
            "norm_bb": rng.random((nbb, 6)).astype(np.float32),
            "conf": rng.random((nbb,)).astype(np.float32)}
    examples = {f"t{i}": {"input_ids": rng.integers(106, 999, 5 + i).tolist(),
                          "img_fname": f"im{i % 6}.npz"} for i in range(10)}
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [106, 28996]}
    feat_db.write_feat_db(str(tmp_path / "pimg"), records, min_bb=5,
                          max_bb=20, fmt=fmt)
    jfeat_db.write_feat_db(str(tmp_path / "jimg"), records, min_bb=5,
                           max_bb=20, fmt=fmt)
    txt_db.write_txt_db(str(tmp_path / "ptxt"), examples, meta)
    jtxt_db.write_txt_db(str(tmp_path / "jtxt"), examples, meta)
    for side in ("p", "j"):
        got = feat_db.DetectFeatDb(str(tmp_path / f"{side}img"), 0.2, 20, 5)
        want = jfeat_db.DetectFeatDb(str(tmp_path / f"{side}img"), 0.2, 20,
                                     5)
        assert got.name2nbb == want.name2nbb
        for name in records:
            _same(got.get_img_feat(name), want.get_img_feat(name))
            _same(got.get_dump(name), want.get_dump(name))
        gt = txt_db.TxtTokDb(str(tmp_path / f"{side}txt"), max_txt_len=12,
                             rank=1, world_size=2)
        wt = jtxt_db.TxtTokDb(str(tmp_path / f"{side}txt"), max_txt_len=12,
                              rank=1, world_size=2)
        assert gt.ids == wt.ids and gt.img2txts == wt.img2txts
        assert txt_db.get_ids_and_lens(gt) == jtxt_db.get_ids_and_lens(wt)
        for i in gt.ids:
            assert gt[i] == wt[i]
        assert gt.combine_inputs([5, 6], [7]) == wt.combine_inputs([5, 6],
                                                                   [7])


@pytest.mark.parametrize("hard_negatives", [0, 2])
def test_itm_dataset_items_match_jax(synth, hard_negatives):
    txt_dir, img_dir = synth
    got = itm.ItmFastDataset(txt_db.TxtTokDb(txt_dir, -1),
                             feat_db.DetectFeatDb(img_dir, 0.2, 20, 5),
                             hard_negatives)
    want = jitm.ItmFastDataset(jtxt_db.TxtTokDb(txt_dir, -1),
                               jfeat_db.DetectFeatDb(img_dir, 0.2, 20, 5),
                               hard_negatives)
    negs = None
    if hard_negatives:
        imgs = sorted(want.txt_db.img2txts)
        negs = ({t: imgs[:3] for t in want.ids},
                {i: want.ids[:3] for i in imgs})
    for ds in (got, want):
        ds.new_epoch(*(negs or ()))
    assert len(got) == len(want) == 24 and got.lens == want.lens
    for i in range(len(want)):
        _same(got[i], want[i])
    batch = itm.itm_fast_collate([got[i] for i in range(5)],
                                 itm.CollateConfig(fixed_batch=8))
    _same(batch, jitm.itm_fast_collate([want[i] for i in range(5)],
                                       jitm.CollateConfig(fixed_batch=8)))


def test_itm_dataset_caption_ids_match_jax(synth, tmp_path):
    from lightningdot_tpu.data.tokenizer import WordPieceTokenizer as JTok
    from lightningdot_tpu_torch.data.tokenizer import WordPieceTokenizer

    txt_dir, img_dir = synth
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "dog", "red",
                "car", "##s"])
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    names = sorted(jtxt_db.TxtTokDb(txt_dir, -1).img2txts)
    meta = {n: {"caption_multiple": ["a red dog", "cars"]} for n in names}
    got = itm.ItmFastDataset(txt_db.TxtTokDb(txt_dir, -1),
                             feat_db.DetectFeatDb(img_dir, 0.2, 20, 5), 0,
                             meta, WordPieceTokenizer(str(tmp_path /
                                                          "vocab.txt")))
    want = jitm.ItmFastDataset(jtxt_db.TxtTokDb(txt_dir, -1),
                               jfeat_db.DetectFeatDb(img_dir, 0.2, 20, 5), 0,
                               meta, JTok(str(tmp_path / "vocab.txt")))
    assert got[3]["img"]["caption_ids"] == want[3]["img"]["caption_ids"] == \
        [101, 104, 106, 105, 102, 107, 108, 102]
    with pytest.raises(ValueError, match="tokenizer"):
        itm.ItmFastDataset(got.txt_db, got.img_db, 0, meta)


# ---------------------------------------------------------------------------
# sampler, loader, prefetch, recycling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("droplast", [False, True])
def test_token_bucket_sampler_matches_jax(seed, droplast):
    lens = np.random.default_rng(seed).integers(5, 60, 500).tolist()
    got = loader.TokenBucketSampler(lens, 100, 1024, droplast=droplast,
                                    seed=seed)
    want = jloader.TokenBucketSampler(lens, 100, 1024, droplast=droplast,
                                      seed=seed)
    for _ in range(2):                       # two epochs of one rng
        assert list(iter(got)) == list(iter(want))


@pytest.mark.parametrize("workers", [1, 3])
def test_data_loader_matches_jax(synth, workers):
    txt_dir, img_dir = synth
    ds = itm.ItmFastDataset(txt_db.TxtTokDb(txt_dir, -1),
                            feat_db.DetectFeatDb(img_dir, 0.2, 20, 5))
    jds = jitm.ItmFastDataset(jtxt_db.TxtTokDb(txt_dir, -1),
                              jfeat_db.DetectFeatDb(img_dir, 0.2, 20, 5))
    got = loader.DataLoader(ds, batch_size=5, shuffle=True, seed=3,
                            collate_fn=itm.itm_fast_collate,
                            num_workers=workers)
    want = jloader.DataLoader(jds, batch_size=5, shuffle=True, seed=3,
                              collate_fn=jitm.itm_fast_collate,
                              num_workers=workers)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same(g, w)


def test_device_prefetcher_order_and_lookahead():
    calls = []

    def put(x):
        calls.append(x)
        return x * 10

    assert list(loader.DevicePrefetcher([1, 2, 3], put=put)) == [10, 20, 30]
    assert calls == [1, 2, 3]
    assert list(loader.DevicePrefetcher([], put=put)) == []
    assert list(loader.DevicePrefetcher([5], put=put)) == [50]


def test_pinned_stager_on_the_cpu_aliases_the_arrays():
    batch = {"txts": {"input_ids": np.arange(6, dtype=np.int32)},
             "n_valid": 3, "txt_index": ["a"]}
    staged = list(loader.DevicePrefetcher(
        [batch], put=loader.PinnedStager(torch.device("cpu"))))[0]
    assert staged.event is None and staged.host is batch
    assert staged["n_valid"] == 3 and staged["txt_index"] == ["a"]
    ids = staged["txts"]["input_ids"]
    assert isinstance(ids, torch.Tensor)
    assert ids.data_ptr() == batch["txts"]["input_ids"].ctypes.data


@pytest.mark.cuda
def test_pinned_stager_copies_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((64, 1024)).astype(np.float16)}
               for _ in range(4)]
    out = list(loader.DevicePrefetcher(
        batches, put=loader.PinnedStager(torch.device("cuda"))))
    for got, want in zip(out, batches):
        assert got.event is not None and got["x"].is_cuda
        np.testing.assert_array_equal(got["x"].cpu().numpy(), want["x"])


def test_pinned_tensor_is_only_a_page_locked_whole_view():
    """On the CPU nothing is page-locked: a plain array, a view and a
    tensor's array all read as not pinned, and only base arrays pool."""
    with padding._POOL_LOCK:
        padding._POOL.clear()
    plain = np.zeros((64, 64, 512), np.float16)
    from_torch = torch.zeros((64, 64, 512), dtype=torch.float16).numpy()
    for a in (plain, plain[:32], from_torch):
        assert padding.pinned_tensor(a) is None
    padding.recycle({"a": plain, "b": plain[:32], "c": from_torch})
    assert _pool_size() == 1


@pytest.mark.cuda
def test_pinned_pool_feeds_the_card_copies():
    """On the card the pooled feature arrays are page-locked once a stager
    exists; the stager reads them in place, and the Recycler pools them
    again after the copies' event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stager = loader.PinnedStager(torch.device("cuda"))
    with padding._POOL_LOCK:
        padding._POOL.clear()
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((40, 512)).astype(np.float16)
             for _ in range(64)]
    host = {"img_feat": padding.pad_feats(feats, 64)}
    assert padding.pinned_tensor(host["img_feat"]) is not None
    rec = padding.Recycler(enabled=True, slack=0)
    staged = next(iter(loader.DevicePrefetcher([host], put=stager)))
    rec.push(staged.host, ready=staged.event)
    rec.flush()
    want = np.zeros((64, 64, 512), np.float16)
    want[:, :40] = np.stack(feats)
    np.testing.assert_array_equal(staged["img_feat"].cpu().numpy(), want)
    assert _pool_size() == 1


def _pool_size():
    with padding._POOL_LOCK:
        return sum(len(v) for v in padding._POOL.values())


def test_recycler_disabled_pools_nothing():
    with padding._POOL_LOCK:
        padding._POOL.clear()
    rec = padding.Recycler(enabled=False)
    for _ in range(4):
        rec.push({"img_feat": np.zeros((64, 64, 512), np.float16)})
    rec.flush()
    assert _pool_size() == 0


def test_recycler_ready_gating_on_an_event():
    """The JAX gating (test_loader_workers.py::test_recycler_ready_gating)
    with a stub of ``torch.cuda.Event``'s ``query()``."""
    class Event:
        def __init__(self):
            self.done = False

        def query(self):
            return self.done

    def big():
        return np.zeros((64, 64, 512), np.float16)   # 4 MB, poolable

    with padding._POOL_LOCK:
        padding._POOL.clear()
    rec = padding.Recycler(enabled=True, slack=1, max_pending=2)
    events = [Event() for _ in range(6)]
    rec.push({"a": big()}, ready=events[0])
    assert _pool_size() == 0                 # within slack
    rec.push({"a": big()}, ready=events[1])
    assert _pool_size() == 0                 # events[0] not done
    events[0].done = True
    rec.push({"a": big()}, ready=events[2])
    assert _pool_size() == 1
    for e in events[3:]:
        rec.push({"a": big()}, ready=e)      # events[1] dropped un-pooled
    assert _pool_size() == 1
    for e in events:
        e.done = True
    rec.flush()
    assert _pool_size() == 4
    out = padding.pad_feats([np.ones((3, 512), np.float16)] * 64, 64)
    assert _pool_size() == 3 and out.shape == (64, 64, 512)
    assert out[:, 3:].max() == 0 and out[:, :3].min() == 1


# ---------------------------------------------------------------------------
# config, factory, trainer utils
# ---------------------------------------------------------------------------

def _parser(mod):
    p = argparse.ArgumentParser()
    groups = (mod.default_params, mod.add_itm_params)
    if mod is jconfig:
        groups += (mod.add_logging_params, mod.add_kd_params)
    for group in groups:
        group(p)
    return p


def test_config_groups_match_jax(tmp_path):
    """The port registers a subset of the JAX flags (those it reads), each
    with the JAX default; parsing, remapping and the banner agree on
    those keys, and the config JSON's keys load whether registered or
    not."""
    cmds = ["--config", "configs/coco_eval.json", "--seed", "3",
            "--test_img_db", "/img/coco", "--img_db_mapping", "/data/x",
            "--txt_db_mapping", "/data/t", "--val_txt_db", "/db/val"]
    got = config.parse_with_config(_parser(config), cmds)
    want = jconfig.parse_with_config(_parser(jconfig), cmds)
    assert vars(got).keys() <= vars(want).keys() and got.seed == 3
    with open("configs/coco_eval.json") as f:
        assert json.load(f).keys() <= vars(got).keys()

    def same(a, b):
        return {k: v for k, v in vars(b).items() if k in vars(a)}

    assert vars(got) == same(got, want)
    config.map_db_dirs(got)
    jconfig.map_db_dirs(want)
    assert vars(got) == same(got, want)
    assert got.test_img_db == "/data/x/coco" and got.val_txt_db == \
        "/data/t/val"
    lines, jlines = [], []
    config.print_args(got, lines.append)
    jconfig.print_args(argparse.Namespace(**same(got, want)), jlines.append)
    assert lines == jlines


@pytest.mark.parametrize("name", ["bert-base-cased", "bert-base-uncased",
                                  "bert-base", "configs/img_base.json"])
def test_resolve_encoder_config_matches_jax(name):
    got = factory.resolve_encoder_config(name, project_dim=768, dropout=0.0)
    want = jfactory.resolve_encoder_config(name, project_dim=768,
                                           dropout=0.0)
    assert got.to_dict() == want.to_dict()
    with pytest.raises(ValueError, match="unknown model config"):
        factory.resolve_encoder_config("no-such-config")


def _small_cfg(tmp_path, **extra):
    path = tmp_path / "small.json"
    path.write_text(json.dumps({**SMALL, "img_dim": 64, **extra}))
    return str(path)


def _args(tmp_path, **kw):
    args = _parser(config).parse_args([])
    cfg = _small_cfg(tmp_path)
    args.txt_model_config = args.img_model_config = cfg
    args.compute_dtype = "f32"
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_build_biencoder_loads_reference_state_dicts(tmp_path):
    """A whole bi-encoder .pt loads strictly; a tower .pt without the
    projection head keeps the seeded head (factory.py:130-149)."""
    src = factory.build_biencoder(_args(tmp_path, project_dim=8), seed=1)
    torch.save({f"module.{k}": v for k, v in src.state_dict().items()},
               tmp_path / "bi.pt")
    got = factory.build_biencoder(
        _args(tmp_path, project_dim=8, biencoder_checkpoint=str(
            tmp_path / "bi.pt")), seed=2)
    for k, v in src.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    tower = {k[len("txt_model."):]: v for k, v in src.state_dict().items()
             if k.startswith("txt_model.") and "encode_proj" not in k}
    tower["cls.predictions.bias"] = torch.zeros(3)   # not the tower's
    torch.save(tower, tmp_path / "txt.pt")
    fresh = factory.build_biencoder(_args(tmp_path, project_dim=8), seed=2)
    over = factory.build_biencoder(
        _args(tmp_path, project_dim=8, txt_checkpoint=str(
            tmp_path / "txt.pt")), seed=2)
    for k, v in over.txt_model.state_dict().items():
        want = (fresh if "encode_proj" in k else src).txt_model.state_dict()
        assert torch.equal(v, want[k]), k
    assert over.compute_dtype == torch.float32 and not over.training
    with pytest.raises(ValueError, match="torch state dicts"):
        factory.build_biencoder(_args(tmp_path, biencoder_checkpoint=str(
            tmp_path / "ckpt_dir")))


def test_trainer_utils_match_jax(synth):
    txt_dir, img_dir = synth
    args = argparse.Namespace(max_txt_len=20, num_hard_negatives=0,
                              inf_minibatch_size=0, train_batch_size=4,
                              valid_batch_size=6, seed=1, loader_workers=2)
    dbs = feat_db.ImageDbGroup(0.2, 20, 5, 36)
    jdbs = jfeat_db.ImageDbGroup(0.2, 20, 5, 36)
    assert dbs[img_dir] is dbs[img_dir]
    got = trainer_utils.load_dataset(dbs, [txt_dir, txt_dir],
                                     [img_dir, img_dir], args, True)
    want = jtrainer_utils.load_dataset(jdbs, [txt_dir, txt_dir],
                                       [img_dir, img_dir], args, True)
    got.new_epoch()
    want.new_epoch()
    assert len(got) == len(want) == 2 * len(got.datasets[0])
    for i in (0, 5, len(want) - 1):
        _same(got[i], want[i])
    shard = trainer_utils.load_dataset(dbs, [txt_dir], [img_dir], args,
                                       True, rank=1, world_size=2)
    assert shard.datasets[0].ids == got.datasets[0].ids[1::2]
    for is_train in (True, False):
        ds = got if is_train else trainer_utils.load_dataset(
            dbs, txt_dir, img_dir, args, False)
        jds = want if is_train else jtrainer_utils.load_dataset(
            jdbs, txt_dir, img_dir, args, False)
        for d in (ds, jds):
            if not is_train:
                d.new_epoch()
        dl = trainer_utils.build_dataloader(ds, itm.itm_fast_collate,
                                            is_train, args)
        jdl = jtrainer_utils.build_dataloader(jds, jitm.itm_fast_collate,
                                              is_train, args)
        assert dl.batch_size == jdl.batch_size
        assert dl.num_workers == jdl.num_workers
        for g, w in zip(dl, jdl):
            _same(g, w)


# ---------------------------------------------------------------------------
# the evaluator and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """A JAX bi-encoder with noise of std 0.2 on every weight (at its init
    scale a tower this small gives nearly one embedding for every input),
    and the port's model with the same weights."""
    from lightningdot_tpu.config import EncoderConfig as JCfg

    jmodel = jbi.BiEncoder(JCfg(**SMALL), JCfg(**SMALL, img_dim=64),
                           compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape)
                   ).astype(np.float32), jmodel.init(jax.random.PRNGKey(0)))
    model = BiEncoder(config.EncoderConfig(**SMALL),
                      config.EncoderConfig(**SMALL, img_dim=64))
    load_tower_(model.txt_model,
                tower_state_dict_from_jax(params["txt_model"]))
    load_tower_(model.img_model,
                tower_state_dict_from_jax(params["img_model"]))
    return jmodel, jax.tree.map(jnp.asarray, params), model


def _loaders(synth, batch=8):
    txt_dir, img_dir = synth
    ds = itm.ItmFastDataset(txt_db.TxtTokDb(txt_dir, -1),
                            feat_db.DetectFeatDb(img_dir, 0.2, 20, 5))
    jds = jitm.ItmFastDataset(jtxt_db.TxtTokDb(txt_dir, -1),
                              jfeat_db.DetectFeatDb(img_dir, 0.2, 20, 5))
    ds.new_epoch()
    jds.new_epoch()
    got = loader.DataLoader(ds, batch_size=batch, collate_fn=lambda x:
                            itm.itm_fast_collate(x, itm.CollateConfig(
                                fixed_batch=batch)))
    want = jloader.DataLoader(jds, batch_size=batch, collate_fn=lambda x:
                              jitm.itm_fast_collate(x, jitm.CollateConfig(
                                  fixed_batch=batch)))
    return got, want, ds.txt_db.img2txts


@pytest.mark.parametrize("hnsw", [False, True])
@pytest.mark.parametrize("batch", [8, 5])
def test_eval_model_on_dataloader_matches_jax(synth, models, hnsw, batch):
    jmodel, params, model = models
    got_loader, want_loader, img2txt = _loaders(synth, batch)
    got = evaluator.eval_model_on_dataloader(
        model, got_loader, img2txt=img2txt, vector_size=32, hnsw=hnsw,
        device="cpu")
    want = jevaluator.eval_model_on_dataloader(
        jmodel, params, want_loader, img2txt=img2txt, vector_size=32,
        hnsw=hnsw)
    assert got.recall == want.recall
    assert got.rank_results[0].keys() == want.rank_results[0].keys()
    assert abs(got.loss - want.loss) <= 1e-5
    assert abs(got.correct_ratio - want.correct_ratio) <= 1e-5
    for side in ("txt", "img"):
        assert list(got.embeddings[side]) == list(want.embeddings[side])
        np.testing.assert_allclose(
            np.stack(list(got.embeddings[side].values())),
            np.stack(list(want.embeddings[side].values())), atol=1e-5)
    # recall recomputed from the vectors with a NumPy exact top-k
    txt = got.embeddings["txt"]
    img_names = list(got.embeddings["img"])
    img = np.stack([got.embeddings["img"][n] for n in img_names])
    ranked = {t: [img_names[j] for j in np.argsort(-(img @ v))[:100]]
              for t, v in txt.items()}
    gt = {t: got_loader.dataset.txt_db.txt2img[t] for t in txt}
    assert metrics.recall_from_ranked_ids(list(txt), ranked, gt) == \
        got.recall[0]


def test_eval_no_eval_and_get_indexer(synth, models):
    jmodel, params, model = models
    got_loader, want_loader, _ = _loaders(synth)
    with pytest.raises(ValueError, match="img2txt"):
        evaluator.eval_model_on_dataloader(model, got_loader, device="cpu")
    res = evaluator.eval_model_on_dataloader(model, got_loader, no_eval=True,
                                             vector_size=32, device="cpu")
    assert res.recall == (None, None) and res.indexers[0].ntotal == 12
    for img_retrieval in (True, False):
        got = evaluator.get_indexer(model, got_loader, vector_size=32,
                                    img_retrieval=img_retrieval,
                                    device="cpu")
        want = jevaluator.get_indexer(jmodel, params, want_loader,
                                      vector_size=32,
                                      img_retrieval=img_retrieval)
        assert got.index_id_to_db_id == want.index_id_to_db_id
        q = np.random.default_rng(1).standard_normal((4, 32)).astype(
            np.float32)
        assert [r[0] for r in got.search_knn(q, 5)] == \
            [r[0] for r in want.search_knn(q, 5)]


def _cli(cfg, txt_dir, img_dir, *extra):
    return ["--txt_model_config", cfg, "--img_model_config", cfg,
            "--test_txt_db", txt_dir, "--test_img_db", img_dir,
            "--valid_batch_size", "8", "--max_bb", "20", "--min_bb", "5",
            "--compute_dtype", "f32", "--inf_minibatch_size", "8", *extra]


def test_eval_cli_end_to_end(synth, tmp_path):
    """The port's ``eval_itm.main`` as tests/test_eval_e2e.py::
    test_eval_cli_end_to_end runs the JAX one: finite loss, recall dicts
    at 1/5/10, and the same recall on a second run; on the card by
    default, so a run without one raises."""
    from lightningdot_tpu_torch.cli.eval_itm import main

    txt_dir, img_dir = synth
    cfg = _small_cfg(tmp_path)
    r = main(_cli(cfg, txt_dir, img_dir, "--device", "cpu"))["test"]
    assert np.isfinite(r["loss"]) and 0 <= r["correct_ratio"] <= 1
    for d in (r["recall_txt"], r["recall_img"]):
        assert set(d.keys()) == {1, 5, 10}
        assert 0.0 <= d[1] <= d[5] <= d[10] <= 1.0
    r2 = main(_cli(cfg, txt_dir, img_dir, "--device", "cpu"))["test"]
    assert r2["recall_txt"] == r["recall_txt"]
    assert abs(r2["loss"] - r["loss"]) < 1e-6
    r3 = main(_cli(cfg, txt_dir, img_dir, "--device", "cpu",
                   "--hnsw_index"))["test"]
    assert r3["recall_txt"] == r["recall_txt"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(_cli(cfg, txt_dir, img_dir))


def test_eval_cli_matches_jax_with_the_same_weights(synth, models, tmp_path):
    """The CLI over a reference-layout .pt of the JAX model's weights gives
    the JAX evaluator's recall, loss and correct ratio."""
    from lightningdot_tpu_torch.cli.eval_itm import main

    jmodel, params, model = models
    torch.save(model.state_dict(), tmp_path / "bi.pt")
    txt_dir, img_dir = synth
    got = main(_cli(_small_cfg(tmp_path), txt_dir, img_dir, "--device",
                    "cpu", "--biencoder_checkpoint",
                    str(tmp_path / "bi.pt")))["test"]
    _, want_loader, img2txt = _loaders(synth)
    want = jevaluator.eval_model_on_dataloader(
        jmodel, params, want_loader, img2txt=img2txt, vector_size=32)
    assert (got["recall_txt"], got["recall_img"]) == want.recall
    assert abs(got["loss"] - want.loss) <= 1e-5
    assert abs(got["correct_ratio"] - want.correct_ratio) <= 1e-5


def test_eval_cli_caption_blending_takes_a_vocab_file(synth, tmp_path):
    from lightningdot_tpu_torch.cli.eval_itm import main

    txt_dir, img_dir = synth
    names = sorted(jtxt_db.TxtTokDb(txt_dir, -1).img2txts)
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({n: {"caption_multiple": [
        "a red dog", "two cars"]} for n in names}))
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "red", "dog",
                "two", "car", "##s"])
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    cmds = _cli(_small_cfg(tmp_path), txt_dir, img_dir, "--device", "cpu",
                "--itm_global_file", str(meta),
                "--caption_score_weight", "0.3")
    with pytest.raises(ValueError, match="--vocab_file"):
        main(cmds)
    r = main(cmds + ["--vocab_file", str(tmp_path / "vocab.txt")])["test"]
    assert np.isfinite(r["loss"])
    assert set(r["recall_img"]) == {1, 5, 10}
