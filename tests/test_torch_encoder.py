"""The port's text tower (lightningdot_tpu_torch.models) against the JAX
package's, on the same weights.

Weights: the JAX initialiser at the small config of
tests/test_encoder_parity.py, with numpy noise on every leaf so that biases
and LayerNorm affines are not trivial. They go to the port through
``tower_state_dict_from_jax``. Tolerances: float32 2e-4 (as the JAX tower
against HF BERT, tests/test_encoder_parity.py:57); bfloat16 0.1 absolute on
unit-scale LayerNorm outputs after two layers, plus cosine >= 0.999 (bf16
rounding at different points compounds through the layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.config import EncoderConfig
from lightningdot_tpu.models import bi_encoder as jbi
from lightningdot_tpu.models import encoder as enc
from lightningdot_tpu.models.checkpoint_torch import export_tower, map_tower
from lightningdot_tpu_torch.models import (BiEncoder, TextEncoder,
                                           dot_product_scores, load_tower_,
                                           load_torch_state_dict,
                                           normalize_keys,
                                           tower_state_dict_from_jax)

# the SMALL config of tests/test_encoder_parity.py
SMALL = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=48, type_vocab_size=2)


def _jax_tower(cfg, seed=0):
    tree = enc.init_encoder_tower(jax.random.PRNGKey(seed), cfg,
                                  with_img=False)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape)
                   ).astype(np.float32), tree)


def _port_tower(cfg, tree):
    tower = TextEncoder(cfg)
    load_tower_(tower, tower_state_dict_from_jax(tree))
    return tower


def _batch(cfg, b=3, s=12, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, 8:] = 0
    mask[2, 3:] = 0
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return ids, mask, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("project_dim", [0, 24])
def test_encode_text_matches_jax(dtype, project_dim):
    cfg = EncoderConfig(**SMALL, project_dim=project_dim)
    tree = _jax_tower(cfg)
    tower = _port_tower(cfg, tree)
    ids, mask, pos = _batch(cfg)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    with torch.no_grad():
        seq, pooled = tower(torch.from_numpy(ids), torch.from_numpy(mask),
                            torch.from_numpy(pos), dtype=tdt)
    want_seq, want_pooled = enc.encode_text(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(pos), dtype=jdt)
    assert seq.dtype == tdt and pooled.shape == (3, cfg.out_size)
    got = [seq.float().numpy(), pooled.float().numpy()]
    want = [np.asarray(want_seq, np.float32),
            np.asarray(want_pooled, np.float32)]
    for g, w in zip(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=2e-4)
        else:
            np.testing.assert_allclose(g, w, atol=0.1)
            cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                                     * np.linalg.norm(w, axis=-1))
            assert cos.min() >= 0.999, cos.min()


def test_bi_encoder_encode_txt_matches_jax():
    cfg = EncoderConfig(**SMALL)
    jmodel = jbi.BiEncoder(cfg, cfg, compute_dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(3))
    model = BiEncoder(cfg)
    load_tower_(model.txt_model, tower_state_dict_from_jax(
        jax.tree.map(np.asarray, params["txt_model"])))
    ids, mask, pos = _batch(cfg, seed=4)
    with torch.no_grad():
        got = model.encode_txt({"input_ids": torch.from_numpy(ids),
                                "attention_mask": torch.from_numpy(mask),
                                "position_ids": torch.from_numpy(pos)})
    want = jmodel.encode_txt(params, {"input_ids": jnp.asarray(ids),
                                      "attention_mask": jnp.asarray(mask),
                                      "position_ids": jnp.asarray(pos)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("project_dim", [0, 24])
def test_state_dict_round_trips_through_the_jax_mappers(project_dim):
    """map_tower(port.state_dict()) is the JAX tree, and
    tower_state_dict_from_jax equals export_tower."""
    cfg = EncoderConfig(**SMALL, project_dim=project_dim)
    tree = _jax_tower(cfg, seed=2)
    sd = tower_state_dict_from_jax(tree)
    want_sd = export_tower(tree, with_img=False)
    assert sd.keys() == want_sd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], want_sd[k], err_msg=k)

    tower = _port_tower(cfg, tree)
    back = map_tower(tower.state_dict(), with_img=False,
                     num_layers=cfg.num_hidden_layers)
    got_leaves, got_def = jax.tree.flatten(back)
    want_leaves, want_def = jax.tree.flatten(tree)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_text_tower_matches_hf_bert(rng):
    """An HF BertModel state dict (the reference's text encoder) loads into
    the port directly and gives the same sequence output."""
    from transformers import BertConfig, BertModel

    torch.manual_seed(0)
    hf = BertModel(BertConfig(hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0,
                              **SMALL)).eval()
    cfg = EncoderConfig(**SMALL)
    tower = TextEncoder(cfg)
    load_tower_(tower, hf.state_dict())
    ids, mask, pos = _batch(cfg, seed=5)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask),
                 position_ids=torch.from_numpy(pos)).last_hidden_state
        seq, _ = tower(torch.from_numpy(ids), torch.from_numpy(mask),
                       torch.from_numpy(pos))
    np.testing.assert_allclose(seq.numpy(), ref.numpy(), atol=2e-4)


def test_checkpoint_loading_helpers(tmp_path):
    cfg = EncoderConfig(**SMALL)
    tree = _jax_tower(cfg, seed=6)
    sd = {f"txt_model.{k}": torch.from_numpy(v)
          for k, v in tower_state_dict_from_jax(tree).items()}
    path = str(tmp_path / "ft.pt")
    torch.save({"model_dict": sd, "epoch": 0}, path)
    loaded = load_torch_state_dict(path)
    assert loaded.keys() == sd.keys()
    renamed = normalize_keys({"module.a.LayerNorm.gamma": np.ones(2),
                              "module.a.LayerNorm.beta": torch.zeros(2)})
    assert set(renamed) == {"a.LayerNorm.weight", "a.LayerNorm.bias"}
    tower = TextEncoder(cfg)
    load_tower_(tower, {k[len("txt_model."):]: v for k, v in loaded.items()})
    np.testing.assert_array_equal(
        tower.bert.embeddings.word_embeddings.weight.detach().numpy(),
        tree["embeddings"]["word"])
    with pytest.raises(RuntimeError):   # strict: a missing key raises
        load_tower_(TextEncoder(cfg), {"bert.embeddings.word_embeddings"
                                       ".weight": tree["embeddings"]["word"]})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_product_scores_matches_jax(dtype, rng):
    """float32 scores from float32 or bfloat16 vectors (the corpus dtype)."""
    q = rng.standard_normal((5, 16)).astype(np.float32)
    c = rng.standard_normal((40, 16)).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    got = dot_product_scores(torch.from_numpy(q).to(tdt),
                             torch.from_numpy(c).to(tdt))
    assert got.dtype == torch.float32
    want = jbi.dot_product_scores(jnp.asarray(q, jdt), jnp.asarray(c, jdt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5)
