"""The Moonlight fine-tuning runner (``runners/itm_train_moe.py``) at a
small size on the CPU, as ``test_bench_control.py`` and
``test_bench_harness.py`` hold ``itm_train.f32``: the program's run reads ``correct`` under float32
limits, the reference computed in blocks equals it computed whole, and
the control and each planted fault fail the cell's limits."""
import json

import numpy as np
import pytest

import tiny
from harness import core

SEED = 2 ** 31 + 977

TEXT = dict(vocab_size=300, hidden_size=32, num_hidden_layers=3,
            first_k_dense_replace=1, intermediate_size=48,
            moe_intermediate_size=16, n_routed_experts=4, router_experts=16,
            first_held_expert=0, n_shared_experts=2, num_experts_per_tok=6,
            routed_scaling_factor=2.446, num_attention_heads=2,
            kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
            v_head_dim=8, rope_theta=50000.0, rms_norm_eps=1e-5,
            norm_topk_prob=True, scoring_func="sigmoid",
            topk_method="noaux_tc", hidden_act="silu", q_lora_rank=None,
            n_group=1, topk_group=1, initializer_range=0.05,
            layer_norm_eps=1e-12)
LIMITS = {"loss_gap": 1e-5, "grad_gap": 2e-4, "change_gap": 1e-3}


def _cell(name):
    with open(tiny.BENCH_DIR / "workloads" / f"{name}.json") as f:
        return json.load(f)


CELLS = {
    "tiny.moe": ("tiny-moon", "tiny_pairs_moe", dict(
        _cell("itm_train.moonlight.bf16"), compute_dtype="f32",
        reference_block=3, warm_steps=4,
        limits=dict(LIMITS, route_mismatch=0.0))),
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("m")
    root = tiny.make(tmp)
    pairs = tiny.FILES["traffic/tiny_pairs.json"]
    files = {
        "configs/tiny-moon.json": dict(TEXT, name="tiny-moon", source="test",
                                       kind="bi_encoder_moe", reduced=[],
                                       project_dim=16, image=tiny.IMAGE),
        "traffic/tiny_pairs_moe.json": dict(pairs, runner="itm_train_moe",
                                            opening_id="drawn"),
    }
    for name, (_, _, cell) in CELLS.items():
        files[f"workloads/{name}.json"] = cell
    for rel, body in files.items():
        (root / rel).write_text(json.dumps(body))
    doc = json.loads((tmp / "BENCHMARK.json").read_text())
    doc["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                         "why": "test"} for n, (c, t, _) in CELLS.items()]
    doc["end_to_end"] = [dict(m, workloads=list(CELLS))
                         if m["name"] == "train_pairs_per_s" else m
                         for m in doc["end_to_end"]
                         if m["name"] != "rerank_pairs_per_s"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_runs_correct(bench, name):
    cell = core.Cell(name, bench_dir=bench)
    result, _, _ = core.run_cell(cell, SEED, 0.5, False, "cpu")
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "train_pairs_per_s" in result["metrics"]


@pytest.mark.parametrize("name", list(CELLS))
def test_control_and_faults_fail_the_limits(bench, name):
    cell = core.Cell(name, bench_dir=bench)
    readings = cell.runner().control(core.Run(cell, SEED, 0.0, False, "cpu"))
    assert set(readings) == {"fp8", "drop_expert", "biased_weights"}
    limits = cell.settings["limits"]
    for control, numbers in readings.items():
        assert any(v > limits[k] for k, v in numbers.items()), (
            control, numbers, limits)


def test_blocks_equal_the_whole_batch(bench):
    """GradCache: the reference's step in blocks of 3 equals it in one
    block, image dropout replayed in both."""
    cell = core.Cell("tiny.moe", bench_dir=bench)
    runner = cell.runner()
    run = core.Run(cell, SEED, 0.0, False, "cpu")
    run.cell.settings["reference_block"] = 3
    caps, regs = runner.pools(run)
    # the opening ids are drawn, the closing one is the EOS stand-in
    assert len({int(c[0]) for c in caps}) > len(caps) // 2
    assert {int(c[-1]) for c in caps} == {102}
    data = runner.base.Pairs(caps, regs, 64)
    batches = runner._batches(run, data, 2)
    seeds = [1, 2]
    state = runner.initial_state(run)
    job = dict(cell.settings, checked_steps=2)
    a = runner.train_steps(state, batches, seeds, [None, None], cell.config,
                           dict(job, reference_block=3))
    b = runner.train_steps(state, batches, seeds, [None, None], cell.config,
                           dict(job, reference_block=64))
    assert np.allclose(a["losses"], b["losses"], rtol=1e-6)
    for k in a["change_norms"]:
        assert abs(a["change_norms"][k] - b["change_norms"][k]) <= 1e-5 * max(
            b["change_norms"][k], 1e-3), k
    assert a["route_mismatch"] == 0.0


def test_moonlight_readers_read_a_traced_window():
    """Each new reader of the Moonlight cell reads a window with the
    program's ``moe.route`` counters and the kernels' device events, and
    gives a share in (0, 100] where it is one; without the program's
    spans the counter-based readers give None."""
    import time
    from types import SimpleNamespace

    import torch

    from harness.trace import TraceData
    from lightningdot_tpu_torch.utils import tracing

    cfg = json.loads((tiny.BENCH_DIR / "configs"
                      / "lightningdot-moonlight-16b-a3b.json").read_text())
    tracing.clear()
    off = tracing.wall_offset_ns()
    t0 = time.perf_counter_ns()
    with tracing.recording():
        for _ in range(12):
            with tracing.span("moe.route"):
                tracing.count("routed_rows", torch.tensor(5300))
                tracing.count("max_expert_rows", 720)
            with tracing.span("moe.experts"):
                time.sleep(0.001)
    t1 = time.perf_counter_ns()
    w0, w1 = t0 + off, t1 + off
    names = {"grouped_kernel<0, 1>((anonymous namespace)::Args)": 0.9,
             "mla_fwd_kernel<__nv_bfloat16>(float)": 0.05,
             "layernorm_fwd_kernel<__nv_bfloat16, 3, false, false, true>(x)":
             0.01, "rope_kernel<__nv_bfloat16>(x)": 0.01,
             "(anonymous namespace)::combine_kernel(x)": 0.01,
             "(anonymous namespace)::scatter_rows_kernel(x)": 0.01,
             "(anonymous namespace)::route_grad_kernel(x)": 0.01}
    device, at = [], w0
    span = (w1 - w0) // 2
    for name, share in names.items():
        device.append((name, at, at + int(share * span)))
        at += int(share * span)
    lens = np.full(512, 14)
    run = SimpleNamespace(
        config=cfg, settings={"compute_dtype": "bf16"},
        calls=[{"txt_shape": (512, 32), "img_shape": (512, 104),
                "txt_lens": lens, "img_lens": np.full(512, 56)}],
        trace=TraceData(device, [("window", w0, w1)]),
        window_s=(w1 - w0) / 1e9)
    got = {}
    for path in sorted((tiny.BENCH_DIR / "metrics").glob("*.moonlight.py")):
        got[path.stem] = core.load_module(path, "t_" + path.stem).read(run)
    assert all(v is not None for v in got.values()), got
    assert got["expert_imbalance.moonlight"] == pytest.approx(720 * 8 / 5300)
    for name, value in got.items():
        if name != "expert_imbalance.moonlight":
            assert 0.0 < value, (name, value)
    tracing.clear()
    assert core.load_module(tiny.BENCH_DIR / "metrics" / "mfu.moonlight.py",
                            "t_mfu").read(run) is None
