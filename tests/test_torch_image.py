"""The port's image tower and corpus encoding (models.encoder.ImgEmbeddings
and ImageEncoder, BiEncoder.encode_img/apply, training.evaluator.
BatchEncoder, serving.get_model_encoded_vecs) against the JAX package's, on
the same weights.

Weights: the JAX initialiser at a small config, with numpy noise on every
leaf, carried to the port through ``tower_state_dict_from_jax`` (the
mirror of ``checkpoint_torch.export_tower(with_img=True)``). The vocabulary
holds 128 ids: the image tower's [CLS] is id 101. Tolerances: float32 1e-5,
after the embeddings and after two layers (the same math, another
summation order); bfloat16 by cosine >= 0.999 (bf16 rounding at other
points compounds through the layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.config import EncoderConfig
from lightningdot_tpu.data.feat_db import DetectFeatDb
from lightningdot_tpu.data.itm import (CollateConfig, ItmFastDataset,
                                       itm_fast_collate)
from lightningdot_tpu.data.loader import DataLoader
from lightningdot_tpu.data.synth import make_synth_dataset
from lightningdot_tpu.data.txt_db import TxtTokDb
from lightningdot_tpu.models import encoder as enc
from lightningdot_tpu.models.bi_encoder import BiEncoder as JBiEncoder
from lightningdot_tpu.models.checkpoint_torch import export_tower
from lightningdot_tpu.serving import (
    get_model_encoded_vecs as jax_encoded_vecs)
from lightningdot_tpu_torch.models import (BiEncoder, ImageEncoder,
                                           init_tower_, load_tower_,
                                           tower_state_dict_from_jax)
from lightningdot_tpu_torch.serving import get_model_encoded_vecs
from lightningdot_tpu_torch.training.evaluator import BatchEncoder

IMG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=48, type_vocab_size=2, img_dim=16)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _noisy(tree, seed, noise=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32), tree)


def _jax_img_tower(cfg, seed=0):
    return _noisy(enc.init_encoder_tower(jax.random.PRNGKey(seed), cfg,
                                         with_img=True), seed)


def _port_img_tower(cfg, tree):
    tower = ImageEncoder(cfg)
    load_tower_(tower, tower_state_dict_from_jax(tree))
    return tower


def _img_batch(cfg, b=3, regions=32, seed=1):
    """[CLS] + ``regions`` regions, ragged masks, float16 features as the
    feature DB stores them."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, regions, cfg.img_dim)).astype(np.float16)
    pos = rng.random((b, regions, 7)).astype(np.float32)
    mask = np.ones((b, regions + 1), np.int64)
    mask[1, regions // 2:] = 0
    mask[2, 5:] = 0
    img_masks = (rng.random((b, regions)) < 0.15).astype(np.int64)
    cls = np.full((b, 1), 101, np.int64)
    return cls, mask, feat, pos, img_masks


def _cosine(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _close(got: torch.Tensor, want, dtype: str, atol: float):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=atol)
    else:
        flat = (-1, got.shape[-1])
        assert _cosine(got.reshape(flat), want.reshape(flat)).min() >= 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_img_embeddings_match_jax(dtype, masked):
    cfg = EncoderConfig(**IMG)
    tree = _jax_img_tower(cfg)
    tower = _port_img_tower(cfg, tree)
    _, _, feat, pos, img_masks = _img_batch(cfg)
    tdt, jdt = DTYPES[dtype]
    img_type = tree["embeddings"]["token_type"][1][None, None, :]
    with torch.no_grad():
        got = tower.bert.img_embeddings(
            torch.from_numpy(feat), torch.from_numpy(pos),
            tower.bert.embeddings.token_type_embeddings.weight[1],
            torch.from_numpy(img_masks) if masked else None, tdt)
    want = enc.img_embeddings(
        jax.tree.map(jnp.asarray, tree["img_embeddings"]), cfg,
        jnp.asarray(feat), jnp.asarray(pos), jnp.asarray(img_type),
        jnp.asarray(img_masks) if masked else None, dtype=jdt)
    assert got.dtype == tdt
    _close(got, want, dtype, atol=1e-5)
    # row 0 of the mask table counts as zero, and is left as stored
    assert tower.bert.img_embeddings.mask_embedding.weight[0].abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regions", [32, 64])    # S = 33 and 65
@pytest.mark.parametrize("project_dim", [0, 24])
def test_encode_image_matches_jax(dtype, regions, project_dim):
    cfg = EncoderConfig(**IMG, project_dim=project_dim)
    tree = _jax_img_tower(cfg)
    tower = _port_img_tower(cfg, tree)
    cls, mask, feat, pos, img_masks = _img_batch(cfg, regions=regions)
    tdt, jdt = DTYPES[dtype]
    with torch.no_grad():
        seq, pooled = tower(*(torch.from_numpy(a)
                              for a in (cls, mask, feat, pos)),
                            img_masks=torch.from_numpy(img_masks), dtype=tdt)
    want_seq, want_pooled = enc.encode_image(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(cls),
        jnp.asarray(mask), jnp.asarray(feat), jnp.asarray(pos),
        img_masks=jnp.asarray(img_masks), dtype=jdt)
    assert seq.shape == (3, regions + 1, 32)
    assert pooled.shape == (3, cfg.out_size) and pooled.dtype == tdt
    _close(seq, want_seq, dtype, atol=1e-5)
    _close(pooled, want_pooled, dtype, atol=1e-5)


def test_image_weights_carry_across_strictly():
    cfg = EncoderConfig(**IMG, project_dim=24)
    tree = _jax_img_tower(cfg)
    sd = tower_state_dict_from_jax(tree)
    ref = export_tower(tree, with_img=True)
    assert sd.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(sd[k], ref[k])
    tower = ImageEncoder(cfg)
    load_tower_(tower, ref)                       # strict: raises on a miss
    got = {k: v.numpy() for k, v in tower.state_dict().items()}
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    with pytest.raises(RuntimeError):
        load_tower_(ImageEncoder(cfg), {k: v for k, v in ref.items()
                                        if "img_embeddings" not in k})


def test_init_image_encoder_follows_the_jax_initialiser():
    cfg = EncoderConfig(**IMG)
    tower = init_tower_(ImageEncoder(cfg), torch.Generator().manual_seed(0))
    ie = tower.bert.img_embeddings
    for w in (ie.img_linear.weight, ie.pos_linear.weight,
              ie.mask_embedding.weight):
        assert abs(float(w.std()) - cfg.initializer_range) < 0.005
    assert float(ie.img_linear.bias.abs().sum()) == 0.0
    assert torch.equal(ie.LayerNorm.weight, torch.ones(32))
    assert float(tower.bert.embeddings.word_embeddings.weight[0]
                 .abs().sum()) == 0.0


def _models(txt_cfg, img_cfg, dtype="float32", seed=0):
    jmodel = JBiEncoder(txt_cfg, img_cfg, compute_dtype=DTYPES[dtype][1])
    params = _noisy(jmodel.init(jax.random.PRNGKey(seed)), seed)
    model = BiEncoder(txt_cfg, img_cfg, compute_dtype=DTYPES[dtype][0])
    load_tower_(model.txt_model, tower_state_dict_from_jax(
        params["txt_model"]))
    load_tower_(model.img_model, tower_state_dict_from_jax(
        params["img_model"]))
    return jmodel, params, model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bi_encoder_apply_matches_jax(dtype):
    cfg = EncoderConfig(**IMG)
    jmodel, params, model = _models(cfg, cfg, dtype)
    cls, mask, feat, pos, _ = _img_batch(cfg, regions=32, seed=2)
    rng = np.random.default_rng(3)
    txts = {"input_ids": rng.integers(1, 128, (3, 16)),
            "attention_mask": np.ones((3, 16), np.int64),
            "position_ids": np.broadcast_to(np.arange(16), (3, 16)).copy()}
    imgs = {"input_ids": cls, "attention_mask": mask, "img_feat": feat,
            "img_pos_feat": pos}
    batch = {"txts": txts, "imgs": imgs, "caps": None}
    encoder = BatchEncoder(model, device="cpu")
    got = encoder(encoder.put(batch))
    want = jmodel.apply(jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, batch))
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.float32
        _close(g, w, dtype, atol=1e-5)


def test_text_only_bi_encoder_has_no_image_tower():
    model = BiEncoder(EncoderConfig(**IMG))
    assert model.img_model is None
    with pytest.raises(ValueError, match="image tower"):
        model.encode_img({})


def test_batch_encoder_checks_token_ids():
    cfg = EncoderConfig(**{**IMG, "vocab_size": 100})   # no id 101
    model = BiEncoder(cfg, cfg)
    cls, mask, feat, pos, _ = _img_batch(cfg)
    with pytest.raises(ValueError, match="vocabulary"):
        BatchEncoder(model, device="cpu").put({"imgs": {
            "input_ids": cls, "attention_mask": mask, "img_feat": feat,
            "img_pos_feat": pos}})


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthdata")
    return make_synth_dataset(str(root), n_imgs=12, txts_per_img=2,
                              img_dim=16, min_bb=5, max_bb=40,
                              max_txt_len=30)


def _loader(txt_dir, img_dir):
    ds = ItmFastDataset(TxtTokDb(txt_dir, -1),
                        DetectFeatDb(img_dir, 0.2, 40, 5))
    ds.new_epoch()
    return DataLoader(ds, batch_size=8, collate_fn=lambda items:
                      itm_fast_collate(items, CollateConfig(fixed_batch=8)))


def test_get_model_encoded_vecs_matches_jax(synth):
    """The whole corpus-encoding path over a synthetic DB: the
    feature/text DB readers, ItmFastDataset, the collate (image sequences
    1 + R bucketed to 32 or 64), the loader, both towers in float32."""
    cfg = EncoderConfig(**{**IMG, "vocab_size": 28996})   # synth's vocab
    jmodel, params, model = _models(cfg, cfg)
    got = get_model_encoded_vecs(model, _loader(*synth), device="cpu")
    want = jax_encoded_vecs(jmodel, jax.tree.map(jnp.asarray, params),
                            _loader(*synth))
    assert got["img_name"] == want["img_name"]
    assert len(got["img_name"]) == 24
    for key in ("img_embed", "caption_embed", "txt_embed"):
        assert got[key].keys() == want[key].keys()
        for k, v in got[key].items():
            assert v.dtype == np.float32 and v.shape == (32,)
            np.testing.assert_allclose(v, np.asarray(want[key][k]),
                                       atol=1e-5)
    assert len(got["img_embed"]) == 12 and len(got["txt_embed"]) == 24


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_long_sequences_on_card(dtype):
    """The attention kernel at the image tower's and the longest text
    bucket's lengths, bit for bit against its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from lightningdot_tpu_torch.ops import attention

    tdt = DTYPES[dtype][0]
    g = torch.Generator(device="cuda").manual_seed(0)
    for s in (65, 105, 128):
        q, k, v = (torch.randn((4, s, 12, 64), device="cuda",
                               generator=g).to(tdt) for _ in range(3))
        bias = torch.zeros((4, 1, 1, s), device="cuda")
        bias[1, ..., s // 2:] = -10000.0
        got = attention.multi_head_attention(q, k, v, bias)
        want = attention._attention_math(q, k, v, bias, 0.125)
        assert torch.equal(got, want)
