"""The port's int8 serving path against the JAX package's: the int8 FFN
(lightningdot_tpu_torch.ops.ffn_int8), the int8 dense layer and tower
(models.quantized), the int8 corpus and approximate top-k (serving).

Inputs come from a numpy seed and go through both packages; the JAX side
runs on the CPU as its own tests run it (the Pallas kernel in interpret
mode). Tolerances, each with its reason:

* int8 FFN, port twin vs JAX: the two frameworks round the bf16 GELU at
  slightly different points (tests/test_torch_ops.py), and a one-ulp
  difference before a requantization moves a value one int8 level. Held as
  tests/test_ffn.py:132-150 holds the TPU kernel: max |diff| <= 1 % of the
  peak and under 5 % of the elements differing (3.2 % at 16 rows, none at
  130).
* quantized weights and the int8 corpus: the same float32 arithmetic in the
  same order, so equal bit for bit.
* int8 tower vs ``encode_text_int8``: bf16 roundings at other points,
  amplified by the per-row requantization of every dense input; cosine
  >= 0.999 per query and max |diff| <= 0.1 on unit-scale outputs (bf16 ulp
  at 4 is 2**-5; two layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu import serving as jserving
from lightningdot_tpu.config import EncoderConfig
from lightningdot_tpu.models import encoder as enc
from lightningdot_tpu.models.bi_encoder import BiEncoder as JBiEncoder
from lightningdot_tpu.ops import ffn_int8 as jffn_int8
from lightningdot_tpu_torch.models import (BiEncoder, QuantizedTextEncoder,
                                           TextEncoder, load_tower_,
                                           tower_state_dict_from_jax)
from lightningdot_tpu_torch.models.quantized import _dense_int8
from lightningdot_tpu_torch.ops import ffn_int8, gemm, launch_counts
from lightningdot_tpu_torch.ops.activations import gelu
from lightningdot_tpu_torch.serving import (Retriever, approx_bin_width,
                                            approx_topk, ranking_equivalent)

SMALL = dict(vocab_size=512, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64, type_vocab_size=2)


def _levels_close(got: np.ndarray, want: np.ndarray) -> None:
    """+-1 int8 level flips only (tests/test_ffn.py:148-150)."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.01 * np.abs(want).max()
    assert (got != want).mean() < 0.05


def _quantize(kernel: np.ndarray):
    """serving.quantize_text_tower's per-output-channel int8, in JAX."""
    k = jnp.asarray(kernel, jnp.float32)
    s = jnp.maximum(jnp.abs(k).max(axis=-2), 1e-8) / 127.0
    q = jnp.clip(jnp.round(k / s[None, :]), -127, 127).astype(jnp.int8)
    return np.asarray(q), np.asarray(s)


def _out_major(q: np.ndarray) -> torch.Tensor:
    """An int8 [in, out] kernel as the port holds it: a view of [out, in]."""
    return torch.from_numpy(np.ascontiguousarray(q.T)).t()


def _ffn_int8_args(rows, h=64, inter=256, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, h)).astype(np.float32)
    q1, s1 = _quantize(0.05 * rng.standard_normal((h, inter)))
    q2, s2 = _quantize(0.05 * rng.standard_normal((inter, h)))
    b1 = (0.01 * rng.standard_normal(inter)).astype(np.float32)
    b2 = (0.01 * rng.standard_normal(h)).astype(np.float32)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(q1), jnp.asarray(s1),
             jnp.asarray(b1), jnp.asarray(q2), jnp.asarray(s2),
             jnp.asarray(b2))
    targs = (torch.from_numpy(x).to(torch.bfloat16), _out_major(q1),
             torch.tensor(s1), torch.from_numpy(b1), _out_major(q2),
             torch.tensor(s2), torch.from_numpy(b2))
    return jargs, targs


@pytest.mark.parametrize("rows", [16, 130])    # 130: ragged last block
def test_ffn_int8_math_matches_jax(rows, monkeypatch):
    monkeypatch.setenv("LDOT_INT8_FFN_BLOCK", "64")
    from lightningdot_tpu.ops.experimental.ffn_int8_pallas import (
        ffn_int8_pallas)
    jargs, targs = _ffn_int8_args(rows)
    got = ffn_int8._ffn_int8_math(*targs)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, 64)
    got = got.float().numpy()
    _levels_close(got, np.asarray(jffn_int8._ffn_int8_math(
        *jargs, erf="exact"), np.float32))
    # the TPU kernel itself, interpret mode. Its GELU (ops/ffn.py::
    # _gelu_kernel) runs in float32 and rounds once, where the serving
    # composition rounds each op to bf16, so most rows see a level flip and
    # most outputs move a little: held at 2 % of the peak (1.4 % at 130)
    pallas = np.asarray(ffn_int8_pallas(*jargs, interpret=True), np.float32)
    assert np.abs(got - pallas).max() <= 0.02 * np.abs(pallas).max()
    # the public op on [..., H] input is the twin on the CPU
    x3 = targs[0].reshape(2, rows // 2, 64)
    out = ffn_int8.ffn_gelu_int8(x3, *targs[1:])
    np.testing.assert_array_equal(out.reshape(rows, 64).float().numpy(), got)


def test_quant_rows_matches_jax():
    """Against the function as the JAX package serves it, under jit (where
    XLA turns "/ 127" into a multiply by the reciprocal, as the port
    writes it)."""
    x = np.random.default_rng(1).standard_normal((300, 40)).astype(
        np.float32)
    x[3] = 0.0                                  # the 1e-8 floor
    q, s = ffn_int8._quant_rows(torch.from_numpy(x))
    jq, js = jax.jit(jffn_int8._quant_rows)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("rows,cols,splits", [
    (16, 1, 12), (32, 1, 12), (37, 1, 12), (256, 1, 6), (2048, 3, 1),
    (4096, 6, 1)])
def test_ffn_int8_plan_covers_every_tile_and_k_slice_once(rows, cols,
                                                          splits):
    """The int8 FFN's two GEMM launches (csrc/ffn_int8.cu, blocks as the
    kernel reads its block index, k tiles of 128): fc1 reduces all of H in
    one block per 64 x 128 tile, a block taking a group of column tiles
    (about two blocks per SM; one tile each at few rows); fc2 splits its
    reduction over I at few rows, to about one block per SM, with no split
    empty; every output tile and k tile is reduced exactly once."""
    k_tile, row_tile = gemm.INT8_K_TILE, gemm.INT8_ROW_TILE
    fc1, fc1_cols, fc2 = ffn_int8.ffn_int8_plan(rows, 768, 3072, 132)
    assert fc1 == gemm.GemmPlan(-(-rows // row_tile), 24, 1, 6)
    assert fc1_cols == cols and fc2.splits == splits
    groups = -(-fc1.col_tiles // cols)            # fc1's grid, x
    covered = [t for x in range(groups)
               for t in range(x * cols, min((x + 1) * cols, fc1.col_tiles))]
    assert sorted(covered) == list(range(fc1.col_tiles))
    assert groups * fc1.row_tiles <= 2 * 132 or cols == 1
    for plan, n, k in ((fc1, 3072, 768), (fc2, 768, 3072)):
        k_tiles = -(-k // k_tile)
        assert (plan.splits - 1) * plan.per < k_tiles <= plan.splits * plan.per
        count = np.zeros((plan.row_tiles, plan.col_tiles, k_tiles), np.int64)
        for z, r, c, kr in gemm.gemm_blocks(plan, rows, n, k, k_tile=k_tile,
                                            row_tile=row_tile):
            assert len(r) and len(c) and len(kr)
            assert kr.start == z * plan.per * k_tile
            count[r.start // row_tile, c.start // 128,
                  kr.start // k_tile:-(-kr.stop // k_tile)] += 1
        assert (count == 1).all()
    if rows <= 256:
        assert fc2.row_tiles * fc2.col_tiles * fc2.splits >= 132 // 2


def _int32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An exact int8 product in int32, independent of ``mm_int8``."""
    out = torch.matmul(a.long(), b.long())
    assert out.abs().max() < 2 ** 31
    return out.to(torch.int32)


def _ffn_int8_blocks(x, w1, s1, b1, w2, s2, b2, num_sms):
    """A CPU model of csrc/ffn_int8.cu: fc1 block by block as
    ``ffn_int8_plan`` lays them out, each quantizing its rows of x on load
    by the row's scale over all of H, writing its tile of gelu(h1) and each
    row's max |gelu(h1)| over the tile's columns; the intermediate's row
    scale taken as the max of those tile maxima; fc2 block by block and
    split by split, each requantizing its k range of the intermediate on
    load into int32 partials, summed split by split, then dequantized."""
    rows, h = x.shape
    inter = w1.shape[1]
    tile, k_tile = gemm.GEMM_TILE, gemm.INT8_K_TILE
    blocks = dict(k_tile=k_tile, row_tile=gemm.INT8_ROW_TILE)
    fc1, _, fc2 = ffn_int8.ffn_int8_plan(rows, h, inter, num_sms)
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-8) * \
        ffn_int8.INV_127
    g = torch.empty((rows, inter), dtype=torch.bfloat16)
    tile_max = torch.zeros((rows, fc1.col_tiles))
    for _, r, c, kr in gemm.gemm_blocks(fc1, rows, inter, h, **blocks):
        assert kr == range(h)
        r, c = slice(r.start, r.stop), slice(c.start, c.stop)
        xq = torch.round(xf[r] / xs[r]).clamp(-127, 127).to(torch.int8)
        acc = _int32_mm(xq, w1[:, c])
        h1 = (acc.float() * xs[r] * s1[c] + b1[c]).to(torch.bfloat16)
        g[r, c] = gelu(h1)
        tile_max[r, c.start // tile] = g[r, c].float().abs().amax(-1)
    gs = torch.clamp(tile_max.amax(-1, keepdim=True), min=1e-8) * \
        ffn_int8.INV_127
    partial = torch.zeros((fc2.splits, rows, h), dtype=torch.int32)
    for z, r, c, kr in gemm.gemm_blocks(fc2, rows, h, inter, **blocks):
        r, c, kr = (slice(x.start, x.stop) for x in (r, c, kr))
        gq = torch.round(g[r, kr].float() / gs[r]).clamp(-127, 127)
        partial[z, r, c] = _int32_mm(gq.to(torch.int8), w2[kr, c])
    acc = partial[0].clone()
    for z in range(1, fc2.splits):
        acc += partial[z]
    return (acc.float() * gs * s2 + b2).to(torch.bfloat16), fc2.splits


@pytest.mark.parametrize("rows,sms,splits", [
    (16, 132, 3), (37, 132, 3), (130, 8, 2), (300, 6, 1), (300, 12, 2)])
def test_ffn_int8_block_plan_reproduces_twin_bit_for_bit(rows, sms, splits):
    """Tiles, splits and the row scale as the kernel computes them give the
    twin's bits: int32 sums are exact in any order and the max of the tile
    maxima is the row's max. H 256 and I 384 make 2 and 3 column tiles and
    3 k tiles of fc2; ragged row counts and (by the SM count) split and
    unsplit fc2 plans."""
    _, targs = _ffn_int8_args(rows, h=256, inter=384, seed=8)
    got, used = _ffn_int8_blocks(*targs, num_sms=sms)
    assert used == splits
    want = ffn_int8._ffn_int8_math(*targs)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_quant_fast_rounds_as_ieee_division():
    """csrc/ffn_int8.cu's quant_fast, in float32 on the CPU: v * (1 /
    scale) rounded by adding 1.5 * 2**23, with the IEEE division taken only
    within 1e-4 of a half-integer, gives round(v / scale) (the twin's
    ``_quant_rows``) for every bf16 value of rows scaled by their own max,
    from 1e-3 to 1e2 and at the 1e-8 floor; the sum's low byte is the int8
    value, unclipped."""
    rng = np.random.default_rng(3)
    magic = np.float32(1.5 * 2 ** 23)
    near_half = np.float32(0.5) - np.float32(1e-4)
    for e in (-3, -1, 0, 2, -10):
        x = torch.from_numpy(
            (rng.standard_normal((256, 768)) * 10.0 ** e).astype(np.float32)
        ).to(torch.bfloat16).float()
        want, scale = ffn_int8._quant_rows(x)
        q = x * (1.0 / scale)
        t = q + magic
        n = t - magic
        near = (q - n).abs() > near_half
        assert near.float().mean() < 0.01
        got = torch.where(near, want.float(), n)
        low = (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)
        assert torch.equal(got, want.float())
        assert torch.equal(torch.where(near, want, low), want)


def test_ffn_int8_wrapper_checks_layout():
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    row_major = torch.zeros(64, 64, dtype=torch.int8)[:, :32]
    with pytest.raises(ValueError):
        ffn_int8._out_major(row_major, "ffn_int8 kernel", "w1")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        w = torch.zeros(64, 64, dtype=torch.int8)
        ffn_int8.ffn_int8_cuda(x, w, torch.ones(64), torch.zeros(64), w,
                               torch.ones(64), torch.zeros(64))


def _jax_tower(cfg, seed=0, noise=0.02):
    tree = enc.init_encoder_tower(jax.random.PRNGKey(seed), cfg,
                                  with_img=False)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32), tree)


def _port_tower(cfg, tree):
    tower = TextEncoder(cfg)
    load_tower_(tower, tower_state_dict_from_jax(tree))
    return tower


def test_quantize_text_tower_matches_jax():
    cfg = EncoderConfig(**SMALL, project_dim=24)
    tree = _jax_tower(cfg)
    qt = jserving.quantize_text_tower(jax.tree.map(jnp.asarray, tree), cfg)
    port = QuantizedTextEncoder(_port_tower(cfg, tree))
    pairs = []
    for i, layer in enumerate(port.layers):
        for name, mine in (("query", layer.query), ("key", layer.key),
                           ("value", layer.value),
                           ("output", layer.output)):
            pairs.append((mine, qt["layers"]["attn"][name], i))
        pairs.append((layer.intermediate, qt["layers"]["mlp"]["intermediate"],
                      i))
        pairs.append((layer.mlp_output, qt["layers"]["mlp"]["output"], i))
    pairs.append((port.proj[0], qt["proj"]["fc1"], None))
    pairs.append((port.proj[2], qt["proj"]["fc2"], None))
    for mine, ref, i in pairs:
        want = {k: np.asarray(v if i is None else v[i])
                for k, v in ref.items()}
        assert mine.weight.dtype == torch.int8
        np.testing.assert_array_equal(mine.kernel.numpy(), want["q"])
        np.testing.assert_array_equal(mine.scale.numpy(), want["scale"])
        np.testing.assert_array_equal(mine.bias.numpy(), want["bias"])
    emb = qt["embeddings"]
    for mine, key in ((port.word_embeddings, "word"),
                      (port.position_embeddings, "position"),
                      (port.token_type_embeddings, "token_type")):
        assert mine.dtype == torch.bfloat16
        np.testing.assert_array_equal(mine.float().numpy(),
                                      np.asarray(emb[key], np.float32))
    np.testing.assert_array_equal(port.emb_ln.weight.numpy(),
                                  np.asarray(emb["ln"]["scale"], np.float32))


@pytest.mark.parametrize("rows", [1, 16, 17, 40])   # <= 16: cuBLAS's floor
def test_dense_int8_matches_jax(rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 48)).astype(np.float32)
    q, s = _quantize(0.05 * rng.standard_normal((48, 40)))
    b = (0.01 * rng.standard_normal(40)).astype(np.float32)
    got = _dense_int8(torch.from_numpy(x).to(torch.bfloat16), _out_major(q),
                      torch.from_numpy(s), torch.from_numpy(b))
    want = jserving._dense_int8(
        {"q": jnp.asarray(q), "scale": jnp.asarray(s), "bias": b},
        jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (rows, 40)
    # exact int32 products; the float32 epilogue rounds once to bf16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def _cosine(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("project_dim", [0, 24])
def test_quantized_tower_matches_encode_text_int8(project_dim):
    cfg = EncoderConfig(**SMALL, project_dim=project_dim)
    tree = _jax_tower(cfg, noise=0.1)
    port = QuantizedTextEncoder(_port_tower(cfg, tree))
    rng = np.random.default_rng(3)
    b, s = 4, 16
    ids = rng.integers(1, cfg.vocab_size, (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, 9:] = 0
    mask[3, 4:] = 0
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (ids, mask, pos)))
    assert got.dtype == torch.bfloat16 and got.shape == (b, cfg.out_size)
    qt = jserving.quantize_text_tower(jax.tree.map(jnp.asarray, tree), cfg)
    want = np.asarray(jserving.encode_text_int8(
        qt, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos)),
        np.float32)
    got = got.float().numpy()
    assert _cosine(got, want).min() >= 0.999
    assert np.abs(got - want).max() <= 0.1


# -- approximate top-k ------------------------------------------------------

def test_approx_bin_width():
    # full COCO padded to 128: 123,392 = 128 x 964; 32-wide bins leave
    # 3,856 of them: the 100th item survives with p = 0.975 (1,928 bins
    # would give 0.9499)
    assert approx_bin_width(123_392, 100, 0.95) == 32
    assert approx_bin_width(123_392, 100, 0.999) == 1    # would need 99k bins
    assert approx_bin_width(384, 100, 0.95) == 1         # bins cover N
    assert approx_bin_width(384, 10, 0.95) == 2
    assert approx_bin_width(1 << 20, 1, 0.95) == 1 << 20  # top-1 is exact


def test_approx_topk_sorted_valid_and_recall():
    rng = np.random.default_rng(4)
    scores = torch.from_numpy(
        rng.standard_normal((16, 123_392)).astype(np.float32))
    k, target = 100, 0.95
    values, idx = approx_topk(scores, k, target)
    assert values.shape == idx.shape == (16, k)
    assert bool((values[:, :-1] >= values[:, 1:]).all())       # sorted
    assert int(idx.min()) >= 0 and int(idx.max()) < scores.shape[1]
    assert all(len(set(row.tolist())) == k for row in idx)    # no repeats
    assert torch.equal(torch.gather(scores, 1, idx), values)  # valid
    exact = torch.topk(scores, k, dim=1).indices
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                      for a, b in zip(idx, exact)])
    assert recall >= target


def test_approx_topk_exact_when_bins_cover_n():
    scores = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 384)).astype(np.float32))
    got = approx_topk(scores, 100, 0.95)
    want = torch.topk(scores, 100, dim=1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the int8 Retriever -------------------------------------------------------

class Tok:
    """Deterministic word-hash tokenizer with BERT's special ids."""
    cls_token_id = 101

    def encode(self, text):
        return [101] + [200 + sum(map(ord, w)) % 300
                        for w in text.split()] + [102]


def _queries(n, words, seed):
    rng = np.random.default_rng(seed)
    vocab = ["dog", "cat", "beach", "red", "car", "man", "tree", "two",
             "sitting", "on", "a", "the", "with", "green", "field"]
    return [" ".join(rng.choice(vocab, words)) for _ in range(n)]


@pytest.fixture(scope="module")
def setup():
    cfg = EncoderConfig(**SMALL, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    jmodel = JBiEncoder(cfg, EncoderConfig(**SMALL, img_dim=16),
                        compute_dtype=jnp.bfloat16)
    # noise of std 0.2 on every weight, as tests/test_torch_serving.py: at
    # its init scale a tower this small embeds every query alike
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape)
                   ).astype(np.float32), jmodel.init(jax.random.PRNGKey(0)))
    model = BiEncoder(cfg, compute_dtype=torch.bfloat16)
    load_tower_(model.txt_model, tower_state_dict_from_jax(
        params["txt_model"]))
    ids = [f"img_{i}" for i in range(300)]
    vecs = np.random.default_rng(1).standard_normal((300, 32)).astype(
        np.float32)
    vecs[7] = 0.0                              # the 1e-12 scale floor
    return {"cfg": cfg, "jmodel": jmodel, "params": params, "model": model,
            "ids": ids, "vecs": vecs}


def _int8_pair(setup, **kw):
    port = Retriever(setup["model"], Tok(), device="cpu", quantization="int8",
                     weight_quantization="int8", topk="approx", **kw)
    ref = jserving.Retriever(setup["jmodel"], setup["params"], Tok(),
                             quantization="int8", weight_quantization="int8",
                             topk="approx", **kw)
    for r in (port, ref):
        r.set_corpus(setup["ids"], setup["vecs"])
    return port, ref


def test_int8_corpus_matches_jax_and_files_cross_load(setup, tmp_path):
    port, ref = _int8_pair(setup)
    assert port._corpus.dtype == torch.int8
    np.testing.assert_array_equal(port._corpus.numpy(),
                                  np.asarray(ref._corpus))
    np.testing.assert_array_equal(port._scales.numpy(),
                                  np.asarray(ref._scales))
    np.testing.assert_array_equal(port._bias.numpy(), np.asarray(ref._bias))

    ref.save_corpus(str(tmp_path / "from_jax"))
    other = Retriever(setup["model"], Tok(), device="cpu",
                      quantization="int8")
    other.load_corpus(str(tmp_path / "from_jax"))
    assert other.ids == setup["ids"]
    assert torch.equal(other._corpus, port._corpus)
    assert torch.equal(other._scales, port._scales)

    port.save_corpus(str(tmp_path / "from_port"))
    ref2 = jserving.Retriever(setup["jmodel"], setup["params"], Tok(),
                              quantization="int8")
    ref2.load_corpus(str(tmp_path / "from_port"))
    np.testing.assert_array_equal(np.asarray(ref2._corpus),
                                  np.asarray(ref._corpus))
    np.testing.assert_array_equal(np.asarray(ref2._scales),
                                  np.asarray(ref._scales))
    with pytest.raises(ValueError, match="quantization"):
        Retriever(setup["model"], Tok(), device="cpu").load_corpus(
            str(tmp_path / "from_jax"))


def test_int8_scores_match_jax(setup):
    """Both towers in float32 (query vectors equal to ~1e-6), int8 corpus,
    exact top-k over the whole corpus: every score, by id, within 1e-3 of
    a peak of ~30 (a rare query element one int8 level apart moves a score
    by ~1e-2 at most; none did at this seed)."""
    model = BiEncoder(setup["cfg"])
    model.load_state_dict(setup["model"].state_dict())
    jmodel = JBiEncoder(setup["cfg"], EncoderConfig(**SMALL, img_dim=16),
                        compute_dtype=jnp.float32)
    port = Retriever(model, Tok(), device="cpu", quantization="int8")
    ref = jserving.Retriever(jmodel, setup["params"], Tok(),
                             quantization="int8")
    queries = _queries(3, 8, seed=7)
    for r in (port, ref):
        r.set_corpus(setup["ids"], setup["vecs"])
    (pi, ps), (ri, rs) = (r.retrieve_batch_arrays(queries, top=300)
                          for r in (port, ref))
    for a, sa, b, sb in zip(pi, ps, ri, rs):
        np.testing.assert_allclose(sa[np.argsort(a)], sb[np.argsort(b)],
                                   atol=1e-3)


def test_int8_retriever_matches_jax(setup):
    """int8 tower + int8 corpus + approximate top-k against the JAX
    package's (whose approx_max_k is exact on the CPU). At recall 0.99 the
    port's bins cover this 384-row corpus, so its top-k is exact too.
    The two int8 towers round bf16 at other points and requantize every
    dense input, so their embeddings differ by up to 0.05 per element
    (cosine >= 0.9998); against 32-d corpus vectors of norm ~5.7 that moves
    a score of order 14 by up to ~0.3, the atol the rankings are held
    at."""
    port, ref = _int8_pair(setup, topk_recall=0.99)
    queries = _queries(6, 7, seed=8)
    mine = port.encode_queries(queries)
    theirs = np.asarray(jserving.encode_text_int8(
        ref._qtower, setup["cfg"], *_jax_tokens(queries)), np.float32)
    assert _cosine(mine, theirs).min() >= 0.9995
    assert np.abs(mine - theirs).max() <= 0.1
    got = port.retrieve_batch(queries, top=10)
    want = ref.retrieve_batch(queries, top=10)
    for g, w in zip(got, want):
        ok, why = ranking_equivalent(g, w, atol=0.3)
        assert ok, why


def _jax_tokens(queries):
    toks = [Tok().encode(q) for q in queries]
    length = 16
    ids = np.zeros((len(toks), length), np.int32)
    mask = np.zeros((len(toks), length), np.int32)
    for i, t in enumerate(toks):
        ids[i, :len(t)] = t
        mask[i, :len(t)] = 1
    pos = np.broadcast_to(np.arange(length), ids.shape)
    return jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos)


def test_int8_approx_retriever_ranks_planted_first(setup):
    """At recall 0.95 the port's top-k is approximate here (2-wide bins);
    each query's own int8-tower embedding, planted at a common norm of 20
    (so that only the direction decides among the planted), still ranks
    first, and warmup runs every bucket."""
    port, _ = _int8_pair(setup)
    queries = _queries(4, 9, seed=9)
    planted = port.encode_queries(queries)
    planted *= 20 / np.linalg.norm(planted, axis=1, keepdims=True)
    port.set_corpus(setup["ids"] + [f"planted_{i}" for i in range(4)],
                    np.concatenate([setup["vecs"], planted]))
    port.warmup(tops=(10,), batches=(1, 4))
    for i, res in enumerate(port.retrieve_batch(queries, top=10)):
        assert res[0][0] == f"planted_{i}"
        assert len({x for x, _ in res}) == 10
    assert launch_counts()["ffn_int8"] == 0       # the CPU takes the twin


@pytest.mark.cuda
def test_ffn_int8_kernel_matches_twin_on_card():
    """The CUDA kernel against its twin on the card at the serving width:
    the same roundings in the same order, so equal bit for bit, and to
    itself on a second launch; at a query batch (32 rows, fc2 split), a
    ragged count and 2,048 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    for rows in (32, 37, 2048):
        _, targs = _ffn_int8_args(rows, h=768, inter=3072, seed=6)
        args = [t.cuda() for t in targs]
        got = ffn_int8.ffn_gelu_int8(*args)
        want = ffn_int8._ffn_int8_math(*args)
        assert torch.equal(got, want)
        assert torch.equal(ffn_int8.ffn_gelu_int8(*args), got)
