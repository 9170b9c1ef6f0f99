"""The Moonlight text tower (``models/moonlight.py``) and its ops' CPU twins
against the plain float32 reference ``torch_reference/moonlight.py``, at a
small size with seeded random weights.

Tolerances: the port's CPU path computes in float32 like the reference,
through other compositions (stacked and grouped experts, the twins' own
orders of summation), so agreement is to float32 rounding: 2e-5 relative
on values, 1e-4 on each gradient leaf's values against that leaf's
largest (sums over the batch, in other orders)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lightningdot_tpu_torch.config import EncoderConfig, MoonlightConfig
from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
from lightningdot_tpu_torch.models.moonlight import MoonlightTextEncoder
from lightningdot_tpu_torch.ops import layernorm, mla_attention, moe, rope
from lightningdot_tpu_torch.training.itm_step import itm_loss_fn

ROOT = Path(__file__).resolve().parents[1]


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "moonlight_reference", ROOT / "torch_reference" / "moonlight.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()

TEXT = dict(vocab_size=300, hidden_size=64, num_hidden_layers=3,
            first_k_dense_replace=1, intermediate_size=96,
            moe_intermediate_size=16, n_routed_experts=8, router_experts=64,
            first_held_expert=0, n_shared_experts=2, num_experts_per_tok=6,
            routed_scaling_factor=2.446, num_attention_heads=2,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, rope_theta=50000.0, rms_norm_eps=1e-5,
            initializer_range=0.05)
IMAGE = dict(vocab_size=300, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=64,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=64, type_vocab_size=2,
             initializer_range=0.02, layer_norm_eps=1e-12, img_dim=24,
             pos_dim=7)
PD = 16
VALUE_RTOL = 2e-5
GRAD_RTOL = 1e-4


def _state(layout, seed, std=0.05, bias_std=0.05):
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in layout:
        if name.endswith("e_score_correction_bias"):
            out[name] = torch.randn(shape, generator=gen) * bias_std
        elif len(shape) >= 2:
            out[name] = torch.randn(shape, generator=gen) * std
        elif name.endswith("bias"):
            out[name] = torch.randn(shape, generator=gen) * 0.01
        else:
            out[name] = 1.0 + torch.randn(shape, generator=gen) * 0.1
    return out


def _batch(seed, b=6, s=12, r=9):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, s + 1, b)
    lens[0] = s
    ids = np.zeros((b, s), np.int64)
    mask = np.zeros((b, s), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(5, 300, n)
        mask[i, :n] = 1
    nreg = rng.integers(2, r + 1, b)
    feat = np.abs(rng.standard_normal((b, r, 24))).astype(np.float32)
    boxes = rng.random((b, r, 7)).astype(np.float32)
    rmask = (np.arange(r)[None] < nreg[:, None]).astype(np.int64)
    feat *= rmask[..., None]
    boxes *= rmask[..., None]
    t = torch.as_tensor
    return {"txts": {"input_ids": t(ids), "attention_mask": t(mask),
                     "position_ids": t(np.tile(np.arange(s), (b, 1)))},
            "imgs": {"input_ids": torch.full((b, 1), 101),
                     "attention_mask": torch.cat(
                         [torch.ones(b, 1, dtype=torch.int64), t(rmask)], 1),
                     "img_feat": t(feat), "img_pos_feat": t(boxes)}}


def _model(seed=0):
    model = BiEncoder(MoonlightConfig.from_dict(dict(TEXT, project_dim=PD)),
                      EncoderConfig.from_dict(dict(IMAGE, project_dim=PD)))
    state = _state(ref.text_layout(TEXT, PD) + ref.image_layout(IMAGE, PD),
                   seed)
    model.load_state_dict(state, strict=True)
    return model, state


def _close(got, want, rtol):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rtol * scale, (
        float((got - want).abs().max()), scale)


def test_tower_loss_and_every_gradient_match_the_reference():
    model, state = _model(1)
    batch = _batch(2)
    loss, _, (txt, img, _) = itm_loss_fn(model, batch)
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    t = batch["txts"]
    _, want_txt = ref.text_tower(p, t["input_ids"], t["attention_mask"],
                                 TEXT)
    im = batch["imgs"]
    want_img = ref.image_tower(p, im["img_feat"], im["img_pos_feat"],
                               im["attention_mask"][:, 1:], IMAGE)
    want = ref.itm_loss(want_txt, want_img)
    want.backward()
    _close(txt.detach(), want_txt.detach(), VALUE_RTOL)
    _close(img.detach(), want_img.detach(), VALUE_RTOL)
    lv, wv = float(loss.detach()), float(want.detach())
    assert abs(lv - wv) <= VALUE_RTOL * abs(wv)
    grads = dict(model.named_parameters())
    assert set(grads) == {k for k in p
                          if not k.endswith("e_score_correction_bias")}
    # a leaf whose gradient is all but zero (a key's bias under softmax)
    # is held against a thousandth of the largest leaf's
    floor = 1e-3 * max(float(v.grad.abs().max()) for v in p.values()
                       if v.grad is not None)
    for name, param in grads.items():
        g = param.grad
        if p[name].grad is None:       # the [CLS] path's unused tables
            assert g is None or not g.any(), name
            continue
        assert g is not None, name
        want_g = p[name].grad
        err = float((g - want_g).abs().max())
        assert err <= GRAD_RTOL * max(float(want_g.abs().max()), floor), (
            name, err, float(want_g.abs().max()))


def test_share_test_held_shares_add_up_to_the_uncut_layer():
    cfg = dict(TEXT, n_routed_experts=64)
    lp = "txt_model.model.layers.1."
    state = _state(ref.text_layout(cfg, PD), 3)
    x = torch.randn(20, cfg["hidden_size"], generator=torch.Generator()
                    .manual_seed(4))
    real = torch.ones(20, dtype=torch.bool)
    real[-3:] = False
    whole = ref.moe(x, real, state, lp, cfg, "f32", (0, 64))
    parts = []
    for j in range(8):
        p = dict(state)
        for w in ("gate_up_proj", "down_proj"):
            key = f"{lp}mlp.experts.{w}.weight"
            p[key] = state[key][8 * j:8 * j + 8]
        parts.append(ref.moe(x, real, p, lp, cfg, "f32", (8 * j, 8),
                             shared=j == 0))
    _close(sum(parts), whole, VALUE_RTOL)
    # the port's layer on one share gives the reference's share
    tower = MoonlightTextEncoder(MoonlightConfig.from_dict(
        dict(TEXT, first_held_expert=16, project_dim=PD)))
    p = {k: v[16:24] if ".mlp.experts." in k else v
         for k, v in state.items()}
    tower.load_state_dict({k[len("txt_model."):]: v for k, v in p.items()
                           if k.startswith("txt_model.")}, strict=True)
    got = tower.model.layers[1].mlp(x, real, torch.float32)
    _close(got.detach(), ref.moe(x, real, p, lp, cfg, "f32", (16, 8)),
           VALUE_RTOL)


@pytest.mark.parametrize("case", ["spread", "one_expert_all_rows"])
def test_grouped_gemm_twins_and_gradients(case):
    gen = torch.Generator().manual_seed(5)
    n, h, inter, e, k = 14, 16, 8, 4, 3
    x = torch.randn(n, h, generator=gen)
    w_gu = torch.randn(e, 2 * inter, h, generator=gen) * 0.3
    w_down = torch.randn(e, h, inter, generator=gen) * 0.3
    if case == "spread":
        # expert 2 of the held four gets no rows; router ids 10-13 held
        sel = torch.tensor([[10, 11, 5], [13, 1, 2], [10, 13, 6]] * 4
                           + [[0, 1, 2], [11, 0, 3]])
        real = torch.ones(n, dtype=torch.bool)
        real[3] = False
    else:
        sel = torch.stack([torch.full((n,), 12), torch.full((n,), 0),
                           torch.full((n,), 1)], 1)
        real = torch.ones(n, dtype=torch.bool)
    w = torch.rand(n, k, generator=gen)
    routing = moe.route(sel, 10, e, real)
    counts = (routing.offsets[1:] - routing.offsets[:-1]).tolist()
    if case == "spread":
        assert counts[2] == 0 and sum(counts) == int(
            ((sel >= 10) & (sel < 14) & real[:, None]).sum())
    else:
        assert counts == [0, 0, n, 0]
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    gur = w_gu.clone().requires_grad_(True)
    dnr = w_down.clone().requires_grad_(True)
    got = moe.routed_experts(xr, wr, gur, dnr, routing)
    want = torch.zeros(n, h)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    gus = w_gu.clone().requires_grad_(True)
    dns = w_down.clone().requires_grad_(True)
    for t in range(n):
        for j in range(k):
            ex = int(sel[t, j]) - 10
            if 0 <= ex < e and real[t]:
                y = ref.swiglu(xs[t:t + 1], gus[ex], dns[ex], "f32")
                want = want.index_add(0, torch.tensor([t]), ws[t, j] * y)
    _close(got.detach(), want.detach(), VALUE_RTOL)
    cot = torch.randn(n, h, generator=gen)
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    for a, b in ((xr, xs), (wr, ws), (gur, gus), (dnr, dns)):
        _close(a.grad, b.grad, GRAD_RTOL)


@pytest.mark.parametrize("padded", [False, True])
def test_dense_swiglu_twin_and_gradient(padded):
    """Every row, or only the real rows (``real_rows``: padding's output
    and gradient 0)."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(9, 16, generator=gen, requires_grad=True)
    w_gu = (torch.randn(2 * 24, 16, generator=gen) * 0.3).requires_grad_()
    w_down = (torch.randn(16, 24, generator=gen) * 0.3).requires_grad_()
    real = torch.tensor([1, 1, 0, 1, 1, 1, 0, 0, 1], dtype=torch.bool)
    rows = moe.real_rows(real) if padded else None
    got = moe.swiglu(x, w_gu, w_down, rows=rows)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, w_gu, w_down)]
    want = ref.swiglu(*leaves, "f32")
    if padded:
        want = want * real[:, None]
        assert not got[~real].any()
    _close(got.detach(), want.detach(), VALUE_RTOL)
    cot = torch.randn(9, 16, generator=gen)
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    for a, b in zip((x, w_gu, w_down), leaves):
        _close(a.grad, b.grad, GRAD_RTOL)


def test_mla_attention_twin_causal_with_pad_keys():
    gen = torch.Generator().manual_seed(7)
    b, s, nh, dqk, dv = 3, 10, 2, 24, 16
    q, k = (torch.randn(b, s, nh, dqk, generator=gen) for _ in range(2))
    v = torch.randn(b, s, nh, dv, generator=gen)
    key_ok = torch.ones(b, s)
    key_ok[1, 6:] = 0
    key_ok[2, 3:] = 0
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = mla_attention.mla_attention(*leaves, key_ok, dqk ** -0.5)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    scores = (qr.transpose(1, 2) @ kr.transpose(1, 2).transpose(-1, -2)
              ) * dqk ** -0.5
    ok = (key_ok[:, None, None, :] > 0) & torch.ones(s, s,
                                                     dtype=torch.bool).tril()
    # a padding query reads nothing: its output is 0
    want = (torch.softmax(scores.masked_fill(~ok, float("-inf")), -1)
            @ vr.transpose(1, 2)).transpose(1, 2) * key_ok[..., None, None]
    _close(got.detach(), want.detach(), VALUE_RTOL)
    # no query reads a later or a padded key
    later = got[0, 0].detach()
    q2 = q.clone()
    q2[0, 5:] += 1.0
    k2, v2 = k.clone(), v.clone()
    k2[0, 5:] += 1.0
    v2[0, 5:] += 1.0
    again = mla_attention.mla_attention(q2, k2, v2, key_ok, dqk ** -0.5)
    assert torch.equal(again[0, :5], got[0, :5].detach())
    assert torch.equal(again[0, 0], later)
    cot = torch.randn(b, s, nh, dv, generator=gen)
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    for a, w in zip(leaves, (qr, kr, vr)):
        _close(a.grad, w.grad, GRAD_RTOL)


def test_rms_norm_and_rope_twins():
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(5, 7, 32, generator=gen, requires_grad=True)
    scale = (1 + 0.1 * torch.randn(32, generator=gen)).requires_grad_()
    got = layernorm.rms_norm(x, scale, 1e-5)
    xr, sr = (t.detach().clone().requires_grad_(True) for t in (x, scale))
    want = ref.rms_norm(xr, sr, 1e-5)
    _close(got.detach(), want.detach(), VALUE_RTOL)
    cot = torch.randn(5, 7, 32, generator=gen)
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    _close(x.grad, xr.grad, GRAD_RTOL)
    _close(scale.grad, sr.grad, GRAD_RTOL)
    y = torch.randn(2, 9, 3, 8, generator=gen, requires_grad=True)
    got = rope.rope(y, 50000.0)
    yr = y.detach().clone().requires_grad_(True)
    want = ref.rope(yr, 50000.0)
    _close(got.detach(), want.detach(), VALUE_RTOL)
    cot = torch.randn(2, 9, 3, 8, generator=gen)
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    _close(y.grad, yr.grad, GRAD_RTOL)
    # position 0 is no rotation, only the de-interleave
    assert torch.allclose(got[:, 0].detach(),
                          torch.cat([y[:, 0, :, 0::2], y[:, 0, :, 1::2]],
                                    -1).detach())


def test_factory_builds_the_tower_from_txt_model_type(tmp_path):
    from types import SimpleNamespace

    from lightningdot_tpu_torch.models.factory import build_biencoder

    path = tmp_path / "moon.json"
    path.write_text(json.dumps(TEXT))
    img = tmp_path / "img.json"
    img.write_text(json.dumps(IMAGE))
    args = SimpleNamespace(img_model_type="uniter-base",
                           txt_model_type="moonlight-16b-a3b",
                           txt_model_config=str(path),
                           img_model_config=str(img), project_dim=PD,
                           compute_dtype="f32")
    model = build_biencoder(args, seed=3)
    assert isinstance(model.txt_model, MoonlightTextEncoder)
    assert model.txt_model.cfg.n_router == 64
    assert len(model.txt_model.moe_layers()) == 2
    bias = model.txt_model.moe_layers()[0].gate.e_score_correction_bias
    assert bias.abs().sum() > 0
    assert "txt_model.model.layers.1.mlp.gate.e_score_correction_bias" in \
        model.state_dict()
    batch = _batch(9)
    txt, img, _ = model.apply(batch)
    assert txt.shape == (6, PD) and torch.isfinite(txt).all()
    with pytest.raises(ValueError, match="outside the port's ranges"):
        MoonlightConfig.from_dict(dict(TEXT, q_lora_rank=64))
    with pytest.raises(ValueError, match="outside the port's ranges"):
        MoonlightConfig.from_dict(dict(TEXT, first_held_expert=60))


def test_train_itm_cli_with_the_moonlight_tower(tmp_path):
    """``cli/train_itm.py --txt_model_type moonlight-16b-a3b`` fine-tunes,
    evaluates and writes a checkpoint that loads back into the tower."""
    from lightningdot_tpu_torch.cli import train_itm
    from lightningdot_tpu_torch.data.synth import make_synth_dataset
    from lightningdot_tpu_torch.training.checkpoints import read_checkpoint

    txt_dir, img_dir = make_synth_dataset(
        str(tmp_path / "db"), n_imgs=8, txts_per_img=2, img_dim=24,
        min_bb=5, max_bb=10, max_txt_len=20, seed=1)
    moon = tmp_path / "moon.json"
    moon.write_text(json.dumps(dict(TEXT, vocab_size=28996)))
    img = tmp_path / "img.json"
    img.write_text(json.dumps(dict(IMAGE, vocab_size=28996)))
    out = str(tmp_path / "out")
    results, _ = train_itm.main([
        "--txt_model_type", "moonlight-16b-a3b",
        "--txt_model_config", str(moon), "--img_model_config", str(img),
        "--project_dim", str(PD), "--train_txt_dbs", txt_dir,
        "--train_img_dbs", img_dir, "--val_txt_db", txt_dir,
        "--val_img_db", img_dir, "--max_bb", "10", "--min_bb", "5",
        "--num_bb", "10", "--max_txt_len", "30", "--compute_dtype", "f32",
        "--train_batch_size", "4", "--valid_batch_size", "8",
        "--inf_minibatch_size", "8", "--num_train_epochs", "1",
        "--learning_rate", "1e-3", "--loader_workers", "1",
        "--output_dir", out, "--device", "cpu"])
    assert 0.0 <= results["best_val_recall_mean"] <= 1.0
    sd, _, _ = read_checkpoint(str(tmp_path / "out" / "biencoder.last"))
    model = BiEncoder(MoonlightConfig.from_dict(dict(TEXT, vocab_size=28996,
                                                     project_dim=PD)),
                      EncoderConfig.from_dict(dict(IMAGE, vocab_size=28996,
                                                   project_dim=PD)))
    model.load_state_dict(sd, strict=True)
