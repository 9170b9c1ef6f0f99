"""The yardstick's arithmetic against hand counts, one shape each."""
import pytest

from harness import counts, roofline
from harness.trace import TraceData, union_seconds


def test_layer_flops_hand_count():
    # s (8 h^2 + 4 h i) + 4 s^2 h at s 10, h 4, i 8
    assert counts.layer_flops(10, 4, 8) == 10 * (8 * 16 + 4 * 32) + 4 * 100 * 4


def test_tower_flops_hand_count():
    cfg = dict(hidden_size=4, intermediate_size=8, num_hidden_layers=2,
               img_dim=6, pos_dim=7)
    # one image: [CLS] + 3 regions; 2 layers, the projection 4 -> 8 -> 5,
    # 3 regions through the 6- and 7-wide embedding products
    want = (2 * counts.layer_flops(4, 4, 8) + 2 * (4 * 8 + 8 * 5)
            + 2 * 3 * 4 * (6 + 7))
    assert counts.tower_flops([4], cfg, 5, regions=True) == want


def test_ffn_counts_hand_count():
    fc1, fc2 = counts.ffn_forward(2, 3, 5, 4, with_h1=True)
    # fc1 reads x (2x3) and w1 (3x5) and b1 (5 float32), writes h1 and
    # gelu(h1) (2x5 each)
    assert fc1 == (4 * (6 + 15) + 4 * 5 + 2 * 4 * 10, 2 * 2 * 3 * 5)
    assert fc2 == (4 * (10 + 15) + 4 * 3 + 4 * 6, 2 * 2 * 5 * 3)
    eval_fc1, _ = counts.ffn_forward(2, 3, 5, 2, with_h1=False)
    assert eval_fc1 == (2 * (6 + 15) + 4 * 5 + 2 * 10, 60)
    assert counts.ffn_dh1(2, 3, 5, 4) == (4 * (6 + 10 + 15 + 10), 60)


def test_attention_counts_hand_count():
    # q, k, v, out [2, 3, 4] float32 and a [2, 3] float32 bias; 4 b s^2 h
    assert counts.attention_forward(2, 3, 4, 4) == (4 * 4 * 24 + 4 * 6,
                                                    4 * 2 * 9 * 4)


def test_bound():
    assert roofline.bound(3.35e12, 1.0, 67e12) == (1000.0, "bytes")
    ms, by = roofline.bound(1.0, 67e12, roofline.PEAK_OPS["f32"])
    assert (ms, by) == (pytest.approx(1000.0), "operations")


def test_union_and_idle_gaps():
    assert union_seconds([(0, 10), (5, 15), (20, 30)]) == 25e-9
    spans = [("window", 0, 100), ("step", 0, 25), ("feed", 25, 60),
             ("step", 60, 100)]
    device = [("k1", 5, 30), ("k2", 50, 75), ("k3", 90, 120),
              ("early", -10, 2)]
    t = TraceData(device, spans)
    assert t.window_s == 100e-9
    # clipped to the window: 0-2, 5-30, 50-75, 90-100; idle 2-5 (in the
    # first step), 30-50 (in the feed), 75-90 (in the second step)
    assert t.busy_s == pytest.approx(62e-9)
    assert t.idle_gaps() == [["feed", pytest.approx(20e-9)],
                             ["step", pytest.approx(15e-9)],
                             ["step", pytest.approx(3e-9)]]
    assert t.seconds_matching(r"^k[12]$") == (pytest.approx(50e-9), 2)


def test_roofline_reader_hand_count(tmp_path):
    import json
    from harness import core
    from tests_support import run_stub
    bench = core.BENCH_DIR
    reader = core.load_module(bench / "metrics"
                              / "ffn_f32_roofline.rerank.py", "r1")
    cfg = json.load(open(bench / "configs" / "uniter-base-cross.json"))
    fc1, fc2 = counts.ffn_forward(128 * 136, 768, 3072, 4, with_h1=False)
    least = 12 * (fc1[1] + fc2[1]) / 67e12      # bound by operations
    run = run_stub(cfg, [("(anonymous namespace)::gemm_kernel<0>(x)", 0,
                          int(2 * least * 1e9))],
                   calls=[{"blocks": [(128, 136)]}])
    assert reader.read(run) == pytest.approx(50.0, rel=1e-6)
