"""The port's corpus sharded over a device mesh (``parallel.mesh.DeviceMesh``
of eight CPU entries, as tests/conftest.py gives JAX eight CPU devices),
held against the JAX package's sharded cases and against the port's
unsharded index and Retriever: ``DenseShardedIndex`` (test_index.py:61,126),
``Retriever(mesh=)`` with a bfloat16 and an int8 corpus
(test_serving.py:115,341), the batching front end over it
(test_serving_frontend.py:132), evaluation through the sharded index
(test_eval_e2e.py:109); and the copies of ``DistributedSampler`` and of the
preemption cadence (test_preemption.py:23,46)."""
import jax
import numpy as np
import pytest
import torch

from lightningdot_tpu import serving as jserving
from lightningdot_tpu.data.loader import DistributedSampler as JSampler
from lightningdot_tpu.index.dense import DenseShardedIndex as JSharded
from lightningdot_tpu.parallel.mesh import data_parallel_mesh
from lightningdot_tpu.training import evaluator as jevaluator
from lightningdot_tpu_torch.data.loader import DistributedSampler
from lightningdot_tpu_torch.index import DenseFlatIndex, DenseShardedIndex
from lightningdot_tpu_torch.parallel import mesh as port_mesh
from lightningdot_tpu_torch.parallel.mesh import DeviceMesh
from lightningdot_tpu_torch.serving import Retriever, ranking_equivalent
from lightningdot_tpu_torch.serving_frontend import BatchingFrontend
from lightningdot_tpu_torch.training import evaluator
from lightningdot_tpu_torch.utils import preemption
from lightningdot_tpu_torch.utils.preemption import PreemptionGuard
from test_torch_eval import _loaders, models, synth  # noqa: F401
from test_torch_serving import Tok, _queries
from test_torch_serving import setup as serving_setup  # noqa: F401

MESH = DeviceMesh(["cpu"] * 8)


def _hold_search(got, want, atol=1e-5):
    assert len(got) == len(want)
    for (g_ids, g_sc), (w_ids, w_sc) in zip(got, want):
        assert g_ids == w_ids
        np.testing.assert_allclose(np.asarray(g_sc), np.asarray(w_sc),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("n,d,k", [(2000, 64, 10), (500, 32, 300)])
def test_sharded_index_matches_jax_and_flat(n, d, k):
    """Eight shards against the JAX package's eight-device index and the
    port's flat index; (500, 32, 300) pads to 1,024 rows, 128 a shard, so
    k is wider than a shard (the local-k clamp)."""
    rng = np.random.default_rng(n)
    data = [(f"v{i}", v) for i, v in
            enumerate(rng.standard_normal((n, d)).astype(np.float32))]
    q = rng.standard_normal((13, d)).astype(np.float32)
    got = DenseShardedIndex(d, MESH)
    got.index_data(data[:n // 2])
    got.index_data(data[n // 2:])
    flat = DenseFlatIndex(d, device="cpu")
    flat.index_data(data)
    want = JSharded(d, data_parallel_mesh())
    want.index_data(data)
    res = got.search_knn(q, k)
    _hold_search(res, want.search_knn(q, k))
    _hold_search(res, flat.search_knn(q, k))
    assert [c.device for c, _ in got._corpus] == [torch.device("cpu")] * 8
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.data_parallel_mesh()    # the cards' mesh, here none


def test_sharded_index_streams_each_shard():
    """Above the score budget each shard takes the streaming top-k."""
    rng = np.random.default_rng(4)
    data = [(f"v{i}", v) for i, v in
            enumerate(rng.standard_normal((900, 16)).astype(np.float32))]
    got = DenseShardedIndex(16, DeviceMesh(["cpu"] * 4))
    got.CORPUS_CHUNK, got.SCORE_BUDGET = 128, 1000
    got.index_data(data)
    flat = DenseFlatIndex(16, device="cpu")
    flat.index_data(data)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    _hold_search(got.search_knn(q, 7), flat.search_knn(q, 7))
    assert all(s.shape[0] % 128 == 0 for s, _ in got._corpus)


@pytest.mark.parametrize("quantization,topk", [
    (None, "exact"), (None, "approx"), ("int8", "exact"), ("int8", "approx")])
def test_sharded_retriever_matches_jax_and_unsharded(serving_setup, tmp_path,
                                                     quantization, topk):
    """``Retriever(mesh=)`` over eight shards against the JAX package's
    sharded Retriever and the port's unsharded one, bf16 and int8 corpora,
    exact and approximate top-k; the corpus files load across packages
    and onto a mesh."""
    s = serving_setup
    kw = dict(quantization=quantization, topk=topk)
    sharded = Retriever(s["model"], Tok(), device="cpu", mesh=MESH, **kw)
    sharded.set_corpus(s["ids"], s["vecs"])
    plain = Retriever(s["model"], Tok(), device="cpu", **kw)
    plain.set_corpus(s["ids"], s["vecs"])
    ref = jserving.Retriever(s["ref"].model, s["ref"].params, Tok(),
                             mesh=data_parallel_mesh(), **kw)
    ref.set_corpus(s["ids"], s["vecs"])
    assert len(sharded._corpus) == 8
    assert sum(c.shape[0] for c in sharded._corpus) % (128 * 8) == 0
    queries = _queries(5, 8, seed=3)
    got = sharded.retrieve_batch(queries, top=10)

    def hold(others, atol):
        for g, w in zip(got, others.retrieve_batch(queries, top=10)):
            ok, why = ranking_equivalent(g, w, atol=atol)
            assert ok, why

    hold(plain, 1e-5)
    hold(ref, 1e-3)
    # an unsharded file onto the mesh; the sharded file into JAX's mesh
    plain.save_corpus(str(tmp_path / "plain"))
    sharded.save_corpus(str(tmp_path / "sharded"))
    loaded = Retriever(s["model"], Tok(), device="cpu", mesh=MESH, **kw)
    loaded.load_corpus(str(tmp_path / "plain"))
    hold(loaded, 1e-5)
    jloaded = jserving.Retriever(s["ref"].model, s["ref"].params, Tok(),
                                 mesh=data_parallel_mesh(), **kw)
    jloaded.load_corpus(str(tmp_path / "sharded"))
    hold(jloaded, 1e-3)


def test_frontend_over_sharded_retriever(serving_setup):
    """Coalesced requests through the front end over the sharded Retriever
    equal the unsharded Retriever's answers."""
    s = serving_setup
    sharded = Retriever(s["model"], Tok(), device="cpu", mesh=MESH)
    sharded.set_corpus(s["ids"], s["vecs"])
    queries = [f"sharded burst {i}" for i in range(6)]
    with BatchingFrontend(sharded, max_batch=4, max_wait_ms=20.0) as fe:
        got = fe.retrieve_many(queries, top=8)
    for q, g in zip(queries, got):
        # another batch size sums in another order: ties within 1e-5
        ok, why = ranking_equivalent(g, s["port"].retrieve_query(q, top=8),
                                     atol=1e-5)
        assert ok, why


def test_eval_with_sharded_index_matches_jax(synth, models):  # noqa: F811
    """``eval_model_on_dataloader(mesh=)`` gives the flat index's results
    and the JAX package's sharded evaluation's recall."""
    jmodel, params, model = models
    got_loader, want_loader, img2txt = _loaders(synth)
    got = evaluator.eval_model_on_dataloader(
        model, got_loader, img2txt=img2txt, vector_size=32, device="cpu",
        mesh=MESH)
    assert isinstance(got.indexers[0], DenseShardedIndex)
    flat = evaluator.eval_model_on_dataloader(
        model, _loaders(synth)[0], img2txt=img2txt, vector_size=32,
        device="cpu")
    want = jevaluator.eval_model_on_dataloader(
        jmodel, params, want_loader, img2txt=img2txt, vector_size=32,
        mesh=data_parallel_mesh())
    assert got.recall == flat.recall == want.recall
    assert got.rank_results == flat.rank_results


@pytest.mark.parametrize("n,world,bs,shuffle,drop_last", [
    (103, 4, 8, True, False), (103, 4, 8, True, True), (16, 3, 5, False,
                                                         False)])
def test_distributed_sampler_matches_jax(n, world, bs, shuffle, drop_last):
    """The copy gives JAX's batches on every rank and epoch: one shuffle of
    all indices per epoch, rank-strided, padded by wrap-around."""
    for rank in range(world):
        got = DistributedSampler(n, world, rank, bs, shuffle, drop_last, 7)
        want = JSampler(n, world, rank, bs, shuffle, drop_last, 7)
        for epoch in range(3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want) and len(got) == len(want)
    seen = sorted(i for r in range(world)
                  for b in DistributedSampler(n, world, r, bs) for i in b)
    assert set(seen) == set(range(n))


def test_preemption_cadence_across_processes(monkeypatch):
    """test_preemption.py:23,46 through the port: one process acts at
    once; across processes a local latch waits for a boundary of
    ``check_every``, where one gather OR-reduces it with the peers'."""
    guard = PreemptionGuard(sim_after_step=3, check_every=25)
    assert [guard.check(s) for s in (1, 2, 3)] == [False, False, True]

    calls = []
    monkeypatch.setattr(preemption, "process_count", lambda: 2)
    monkeypatch.setattr(preemption, "host_all_gather",
                        lambda flag: calls.append(flag) or [flag, False])
    guard = PreemptionGuard(check_every=4)
    guard.requested = True
    assert [guard.check(s) for s in (1, 2, 3)] == [False] * 3
    assert calls == []
    assert guard.check(4) is True and len(calls) == 1

    monkeypatch.setattr(preemption, "host_all_gather",
                        lambda flag: [flag, True])
    guard = PreemptionGuard(check_every=2)
    assert guard.check(1) is False
    assert guard.check(2) is True and guard.requested
    assert jax.device_count() == 8
