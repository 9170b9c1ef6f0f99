"""The port's cross-encoders (``lightningdot_tpu_torch.models.cross_encoder``,
``models/ot.py``, the joint and image-only encoders, the weight carries
and ``load_cross_encoder``) against the JAX package on the same weights
and inputs.

Sizes: the JAX cross-encoder tests' tiny configs (hidden 32, 2 layers, 4
heads, intermediate 64, img_dim 16; the Fast image stream 1 layer),
float32, weights with std-0.2 noise so that pairs score apart. Tolerances:
rank scores, ITM logits and OT distances within 1e-5; gradients within
1e-5 of the largest gradient; the HF-BERT goldens within 2e-4.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.config import EncoderConfig as JCfg
from lightningdot_tpu.models import checkpoint_torch as jckpt
from lightningdot_tpu.models import cross_encoder as jce
from lightningdot_tpu.models.ot import optimal_transport_dist as j_ot
from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.models import cross_encoder as ce
from lightningdot_tpu_torch.models import weights
from lightningdot_tpu_torch.models.factory import load_cross_encoder
from lightningdot_tpu_torch.models.ot import optimal_transport_dist
from lightningdot_tpu_torch.training.checkpoints import load_state_dict_strict
from tests.test_encoder_parity import SMALL, TorchUniterImageEmbeddings

TINY = dict(vocab_size=256, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, img_dim=16, num_hidden_layers_img=1,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ATOL = 1e-5


def noisy(tree, seed):
    """JAX params plus std-0.2 noise (random-init scores would tie)."""
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x) + 0.2 * r.standard_normal(x.shape).astype(np.float32)),
        tree)


def joint_pair(seed=0, fast=False):
    """(JAX model, params, port model) holding the same weights."""
    jcfg, cfg = JCfg(**TINY), EncoderConfig(**TINY)
    if fast:
        jm, pm = jce.CrossEncoderFast(jcfg), ce.CrossEncoderFast(cfg)
        params = noisy(jm.init(jax.random.PRNGKey(seed)), seed)
        sd = weights.cross_encoder_fast_state_dict_from_jax(params)
    else:
        jm, pm = jce.CrossEncoder(jcfg), ce.CrossEncoder(cfg)
        params = noisy(jm.init(jax.random.PRNGKey(seed)), seed)
        sd = weights.cross_encoder_state_dict_from_jax(params)
    load_state_dict_strict(pm, sd)
    return jm, params, pm


def joint_batch(rng, bs=6, tl=8, nr=5, masked=True):
    mask = np.ones((bs, tl + nr), np.int32)
    if masked:
        mask[1, tl + 3:] = 0
        mask[2, 5:tl] = 0
    return {
        "input_ids": rng.integers(1, 256, (bs, tl)).astype(np.int32),
        "position_ids": np.broadcast_to(np.arange(tl, dtype=np.int32),
                                        (bs, tl)).copy(),
        "img_feat": rng.standard_normal((bs, nr, 16)).astype(np.float32),
        "img_pos_feat": rng.random((bs, nr, 7)).astype(np.float32),
        "attn_masks": mask,
    }


def tj(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tt(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def test_rank_scores_itm_logits_and_triplet_loss_match_jax(rng):
    jm, params, pm = joint_pair()
    batch = joint_batch(rng)
    want = np.asarray(jm.rank_scores(params, tj(batch)))
    got = pm.rank_scores(tt(batch)).detach().numpy()
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.ptp(want) > 0.05       # the pairs score apart
    want_itm, _ = jm.itm_scores(params, tj(batch), compute_loss=False)
    got_itm, _ = pm.itm_scores(tt(batch), compute_loss=False)
    np.testing.assert_allclose(got_itm.detach().numpy(), np.asarray(want_itm),
                               atol=ATOL)
    loss_j = jm.apply(params, dict(tj(batch), sample_size=3))
    loss_t = pm.apply(dict(tt(batch), sample_size=3))
    assert tuple(loss_t.shape) == (2, 2)
    np.testing.assert_allclose(loss_t.detach().numpy(), np.asarray(loss_j),
                               atol=ATOL)


def test_triplet_loss_gradient_matches_jax(rng):
    jm, params, pm = joint_pair(1)
    batch = joint_batch(rng)
    g_j = jax.grad(lambda p: jm.apply(p, tj(batch), sample_size=3).mean()
                   )(params)
    pm.apply(tt(batch), sample_size=3).mean().backward()
    grads = weights.cross_encoder_state_dict_from_jax(
        jax.tree.map(np.asarray, g_j))
    scale = max(np.abs(v).max() for v in grads.values())
    assert scale > 0
    for name, p in pm.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(g, grads[name], atol=ATOL * scale,
                                   err_msg=name)


def test_init_output_and_gather_index(rng):
    jm, params, pm = joint_pair(2)
    pm.init_output()
    seeded = jce.CrossEncoder.init_output(params)
    np.testing.assert_array_equal(pm.rank_output.weight.detach().numpy(),
                                  np.asarray(seeded["rank_output"]["kernel"]).T)
    np.testing.assert_array_equal(pm.rank_output.bias.detach().numpy(),
                                  np.asarray(seeded["rank_output"]["bias"]))
    batch = joint_batch(rng)
    plain = pm.encode(tt(batch))
    # identity compaction equals none; a permutation equals JAX's
    gi = np.broadcast_to(np.arange(13, dtype=np.int32), (6, 13)).copy()
    torch.testing.assert_close(pm.encode(tt(dict(batch, gather_index=gi))),
                               plain, atol=1e-6, rtol=0)
    perm = np.stack([rng.permutation(13) for _ in range(6)]).astype(np.int32)
    want = jm.encode(params, tj(dict(batch, gather_index=perm)))
    got = pm.encode(tt(dict(batch, gather_index=perm)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def _ot_inputs(rng, b=3, m=6, n=5, d=8):
    txt = rng.standard_normal((b, m, d)).astype(np.float32)
    img = rng.standard_normal((b, n, d)).astype(np.float32)
    tpad = np.zeros((b, m), bool)
    tpad[:, 4:] = True
    ipad = np.zeros((b, n), bool)
    ipad[1, 3:] = True
    return txt, img, tpad, ipad


def test_ot_distance_and_gradient_match_jax(rng):
    txt, img, tpad, ipad = _ot_inputs(rng)
    want = j_ot(jnp.asarray(txt), jnp.asarray(img), jnp.asarray(tpad),
                jnp.asarray(ipad))
    g_want = jax.grad(lambda t: jnp.sum(j_ot(
        t, jnp.asarray(img), jnp.asarray(tpad), jnp.asarray(ipad)) ** 2))(
        jnp.asarray(txt))
    t = torch.from_numpy(txt).requires_grad_(True)
    got = optimal_transport_dist(t, torch.from_numpy(img),
                                 torch.from_numpy(tpad),
                                 torch.from_numpy(ipad))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_want), atol=ATOL)
    # the padded tail does not move the distance (the JAX case)
    txt2 = txt.copy()
    txt2[:, 4:] = 123.0
    again = optimal_transport_dist(torch.from_numpy(txt2),
                                   torch.from_numpy(img),
                                   torch.from_numpy(tpad),
                                   torch.from_numpy(ipad))
    torch.testing.assert_close(again, got.detach(), atol=ATOL, rtol=0)


def test_itm_scores_with_ot_match_jax(rng):
    jm, params, pm = joint_pair(3)
    batch = joint_batch(rng, masked=False)
    targets = np.array([1, 0, 1, 0, 1, 1], np.int32)
    tpad = np.zeros((6, 8), bool)
    tpad[2, 6:] = True
    ipad = np.zeros((6, 5), bool)
    ipad[1, 3:] = True
    for pos_only in (False, True):
        nll_j, ot_j = jm.itm_scores(
            params, tj(batch), targets=jnp.asarray(targets),
            ot_inputs={"txt_pad": jnp.asarray(tpad),
                       "img_pad": jnp.asarray(ipad)}, ot_pos_only=pos_only)
        nll_t, ot_t = pm.itm_scores(
            tt(batch), targets=torch.from_numpy(targets),
            ot_inputs={"txt_pad": torch.from_numpy(tpad),
                       "img_pad": torch.from_numpy(ipad)},
            ot_pos_only=pos_only)
        np.testing.assert_allclose(nll_t.detach().numpy(), np.asarray(nll_j),
                                   atol=ATOL)
        for a, b in zip(jax.tree.leaves(ot_j),
                        ot_t if isinstance(ot_t, tuple) else (ot_t,)):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       atol=ATOL)
    gi = np.broadcast_to(np.arange(13, dtype=np.int32), (6, 13)).copy()
    with pytest.raises(NotImplementedError, match="ot_scatter"):
        pm.itm_scores(tt(dict(batch, gather_index=gi)),
                      targets=torch.from_numpy(targets),
                      ot_inputs={"txt_pad": torch.from_numpy(tpad),
                                 "img_pad": torch.from_numpy(ipad)})


def _group(rng, n, shared, tl=8, nr=5):
    n_txt, n_img = (1, n) if shared == "t" else (n, 1)
    return {
        "input_ids": rng.integers(1, 256, (n_txt, tl)).astype(np.int32),
        "position_ids": np.arange(tl, dtype=np.int32)[None],
        "img_feat": rng.standard_normal((n_img, nr, 16)).astype(np.float32),
        "img_pos_feat": rng.random((n_img, nr, 7)).astype(np.float32),
        "attn_masks": np.ones((n, tl + nr), np.int32),
    }


@pytest.mark.parametrize("sample_from", ["t", "i"])
def test_mine_and_apply_selects_what_jax_selects(rng, sample_from):
    """The same hard negatives (by the scores they carry) and the same
    triplet loss as JAX's self-mining (test_teacher_hardneg.py's case)."""
    n, hard = 9, 3
    jm0, params, _ = joint_pair(4)
    jm = jce.CrossEncoderHardNeg(JCfg(**TINY), hard_size=hard)
    pm = ce.CrossEncoderHardNeg(EncoderConfig(**TINY), hard_size=hard)
    load_state_dict_strict(pm, weights.cross_encoder_state_dict_from_jax(
        params))
    batch = _group(rng, n, sample_from)
    want = jm.apply(params, tj(batch), deterministic=False,
                    rng=jax.random.PRNGKey(1), sample_from=sample_from)
    pm.train()
    seen = {}
    real_topk = torch.topk

    def spy(x, k):
        out = real_topk(x, k)
        seen["idx"] = out.indices
        return out

    torch.topk = spy
    try:
        got = pm.apply(tt(batch), sample_from=sample_from)
    finally:
        torch.topk = real_topk
    assert pm.training      # the scoring pass restored the mode
    # the indices JAX's lax.top_k picks, from the same eval-mode scores
    full = dict(batch)
    key = "input_ids" if sample_from == "t" else "img_feat"
    full[key] = np.repeat(batch[key], n, axis=0)
    if sample_from == "i":
        full["img_pos_feat"] = np.repeat(batch["img_pos_feat"], n, axis=0)
    full["position_ids"] = np.repeat(batch["position_ids"], n, axis=0)
    scores = np.asarray(jm0.rank_scores(params, tj(full)))[:, 0]
    _, j_idx = jax.lax.top_k(jnp.asarray(scores[1:]), hard)
    np.testing.assert_array_equal(seen["idx"].numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def test_fast_rank_scores_and_loss_match_jax(rng):
    jm, params, pm = joint_pair(5, fast=True)
    n, tl, nr = 4, 9, 6
    batch = {
        "input_ids": rng.integers(1, 256, (n, tl)).astype(np.int32),
        "position_ids": np.arange(tl, dtype=np.int32)[None],
        "img_feat": rng.standard_normal((n, nr, 16)).astype(np.float32),
        "img_pos_feat": rng.random((n, nr, 7)).astype(np.float32),
        "attn_masks_text": np.ones((n, tl), np.int32),
        "attn_masks_img": np.ones((n, nr), np.int32),
    }
    batch["attn_masks_img"][2, 4:] = 0
    want = np.asarray(jm.rank_scores(params, tj(batch)))
    got = pm.rank_scores(tt(batch)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # a shared text is encoded once and broadcast (the mining pools)
    shared = dict(batch, input_ids=batch["input_ids"][:1],
                  attn_masks_text=batch["attn_masks_text"][:1])
    np.testing.assert_allclose(pm.rank_scores(tt(shared)).detach().numpy(),
                               np.asarray(jm.rank_scores(params, tj(shared))),
                               atol=ATOL)
    g_j = jax.grad(lambda p: jm.apply(p, tj(batch), sample_size=2).mean()
                   )(params)
    pm.apply(tt(batch), sample_size=2).mean().backward()
    grads = weights.cross_encoder_fast_state_dict_from_jax(
        jax.tree.map(np.asarray, g_j))
    scale = max(np.abs(v).max() for v in grads.values())
    for name, p in pm.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(g, grads[name], atol=ATOL * scale,
                                   err_msg=name)


@pytest.fixture(scope="module")
def torch_joint():
    from transformers import BertConfig, BertModel

    torch.manual_seed(7)
    bert = BertModel(BertConfig(hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0, **SMALL))
    bert.eval()
    img_emb = TorchUniterImageEmbeddings(SMALL["hidden_size"], img_dim=16)
    img_emb.eval()
    return (bert, img_emb, torch.nn.Linear(SMALL["hidden_size"], 2),
            torch.nn.Linear(SMALL["hidden_size"], 1))


def test_hf_bert_golden_through_both_packages(torch_joint, rng):
    """tests/test_cross_encoder_parity.py's golden: one state dict read by
    both packages (the port through ``cross_encoder_keys``)."""
    bert, img_emb, itm_output, rank_output = torch_joint
    sd = {f"bert.{k}": v for k, v in bert.state_dict().items()}
    sd.update({f"bert.img_embeddings.{k}": v
               for k, v in img_emb.state_dict().items()})
    sd.update({f"itm_output.{k}": v for k, v in itm_output.state_dict().items()})
    sd.update({f"rank_output.{k}": v
               for k, v in rank_output.state_dict().items()})
    cfg = dict(SMALL, img_dim=16, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    pm = ce.CrossEncoder(EncoderConfig(**cfg))
    load_state_dict_strict(pm, weights.cross_encoder_keys(sd))
    params = jckpt.map_cross_encoder(sd, num_layers=cfg["num_hidden_layers"])

    b, tl, nr = 3, 10, 5
    ids = rng.integers(1, SMALL["vocab_size"], (b, tl))
    feat = rng.standard_normal((b, nr, 16)).astype(np.float32)
    pos = rng.random((b, nr, 7)).astype(np.float32)
    mask = np.ones((b, tl + nr), np.int32)
    mask[1, tl + 3:] = 0
    with torch.no_grad():
        temb = bert.embeddings(
            input_ids=torch.from_numpy(ids).long(),
            position_ids=torch.arange(tl)[None].expand(b, tl),
            token_type_ids=torch.zeros(b, tl, dtype=torch.long))
        type1 = bert.embeddings.token_type_embeddings(
            torch.ones(b, nr, dtype=torch.long))
        hidden = torch.cat([temb, img_emb(torch.from_numpy(feat),
                                          torch.from_numpy(pos), type1)], 1)
        ext = (1.0 - torch.from_numpy(mask).float())[:, None, None, :] * -1e4
        for layer in bert.encoder.layer:
            hidden = layer(hidden, attention_mask=ext)[0]
        pooled = torch.tanh(bert.pooler.dense(hidden[:, 0]))
        ref_rank, ref_itm = rank_output(pooled), itm_output(pooled)
    batch = {"input_ids": ids.astype(np.int32),
             "position_ids": np.broadcast_to(np.arange(tl, dtype=np.int32),
                                             (b, tl)).copy(),
             "img_feat": feat, "img_pos_feat": pos, "attn_masks": mask}
    got_rank = pm.rank_scores(tt(batch)).detach()
    got_itm, _ = pm.itm_scores(tt(batch), compute_loss=False)
    torch.testing.assert_close(got_rank, ref_rank, atol=2e-4, rtol=0)
    torch.testing.assert_close(got_itm.detach(), ref_itm, atol=2e-4, rtol=0)
    np.testing.assert_allclose(
        got_rank.numpy(), np.asarray(jce.CrossEncoder(
            JCfg(**cfg)).rank_scores(params, tj(batch))), atol=ATOL)


def test_uniter_warm_start_filters_heads_and_seeds_rank(tmp_path, rng):
    """A uniter-base.pt-shaped file (pre-training heads, no rank head):
    the heads are skipped, rank_output is itm_output's row 1, and both
    packages' load_cross_encoder give the same scores; a file with its own
    rank head keeps it."""
    jm, params, pm = joint_pair(6)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          weights.cross_encoder_state_dict_from_jax(params).items()}
    sd.pop("rank_output.weight")
    sd.pop("rank_output.bias")
    sd["cls.predictions.bias"] = torch.zeros(256)
    sd["feat_regress.weight"] = torch.zeros(16, 32)
    sd["bert.embeddings.position_ids"] = torch.arange(64)[None]
    torch.save(sd, tmp_path / "uniter.pt")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(EncoderConfig(**TINY).to_dict()))
    port = load_cross_encoder(str(tmp_path / "uniter.pt"),
                              model_config=str(cfg_path), device="cpu")
    torch.testing.assert_close(port.rank_output.weight,
                               port.itm_output.weight[1:2])
    from lightningdot_tpu.models.factory import load_cross_encoder as j_load
    jmodel, jparams = j_load(str(tmp_path / "uniter.pt"),
                             model_config=str(cfg_path))
    batch = joint_batch(rng)
    np.testing.assert_allclose(
        port.rank_scores(tt(batch)).detach().numpy(),
        np.asarray(jmodel.rank_scores(jparams, tj(batch))), atol=ATOL)
    with_rank = {**sd, "rank_output.weight": torch.ones(1, 32),
                 "rank_output.bias": torch.zeros(1)}
    torch.save(with_rank, tmp_path / "teacher.pt")
    port = load_cross_encoder(str(tmp_path / "teacher.pt"),
                              model_config=str(cfg_path), device="cpu")
    torch.testing.assert_close(port.rank_output.weight, torch.ones(1, 32))


def test_fast_torch_golden_through_both_packages(rng):
    """tests/test_teacher_hardneg.py's Fast golden (two HF BERT streams,
    the image stream over regions only, tanh poolers, cosine): one state
    dict read by both packages, the port within 2e-4 of the golden and
    1e-5 of JAX."""
    from transformers import BertConfig, BertModel

    torch.manual_seed(3)
    bert = BertModel(BertConfig(hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0, **SMALL))
    img_bert = BertModel(BertConfig(hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0,
                                    **dict(SMALL, num_hidden_layers=1)))
    img_emb_t = TorchUniterImageEmbeddings(SMALL["hidden_size"], img_dim=16)
    img_emb_i = TorchUniterImageEmbeddings(SMALL["hidden_size"], img_dim=16)
    for m in (bert, img_bert, img_emb_t, img_emb_i):
        m.eval()
    sd = {f"bert.{k}": v for k, v in bert.state_dict().items()}
    sd.update({f"bert.img_embeddings.{k}": v
               for k, v in img_emb_t.state_dict().items()})
    sd.update({f"img_bert.{k}": v for k, v in img_bert.state_dict().items()})
    sd.update({f"img_bert.img_embeddings.{k}": v
               for k, v in img_emb_i.state_dict().items()})
    cfg = dict(SMALL, img_dim=16, num_hidden_layers_img=1,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    pm = ce.CrossEncoderFast(EncoderConfig(**cfg))
    own = pm.state_dict()
    loaded = weights.cross_encoder_keys(sd)
    load_state_dict_strict(pm, {k: loaded.get(k, v) for k, v in own.items()})
    params = jckpt.map_cross_encoder_fast(sd, num_layers=2, num_layers_img=1)

    n, tl, nr = 4, 9, 6
    ids = rng.integers(1, SMALL["vocab_size"], (n, tl))
    feat = rng.standard_normal((n, nr, 16)).astype(np.float32)
    pos = rng.random((n, nr, 7)).astype(np.float32)
    tmask = np.ones((n, tl), np.int32)
    imask = np.ones((n, nr), np.int32)
    imask[2, 4:] = 0
    with torch.no_grad():
        tout = bert(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(tmask).long(),
                    position_ids=torch.arange(tl)[None].expand(n, tl)
                    ).last_hidden_state
        pooled_t = torch.tanh(bert.pooler.dense(tout[:, 0]))
        type1 = img_bert.embeddings.token_type_embeddings(
            torch.ones(n, nr, dtype=torch.long))
        hidden = img_emb_i(torch.from_numpy(feat), torch.from_numpy(pos),
                           type1)
        ext = (1.0 - torch.from_numpy(imask).float())[:, None, None, :] * -1e4
        for layer in img_bert.encoder.layer:
            hidden = layer(hidden, attention_mask=ext)[0]
        pooled_i = torch.tanh(img_bert.pooler.dense(hidden[:, 0]))
        want = torch.nn.CosineSimilarity()(pooled_t, pooled_i)
    batch = {"input_ids": ids.astype(np.int32),
             "position_ids": np.arange(tl, dtype=np.int32)[None],
             "img_feat": feat, "img_pos_feat": pos,
             "attn_masks_text": tmask, "attn_masks_img": imask}
    got = pm.rank_scores(tt(batch)).detach()
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jce.CrossEncoderFast(JCfg(**cfg)).rank_scores(
            params, tj(batch))), atol=ATOL)
    assert tuple(pm.apply(tt(batch), sample_size=4).shape) == (1, 3)
