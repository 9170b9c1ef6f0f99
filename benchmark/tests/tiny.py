"""A copy of the benchmark at a size the CPU runs in seconds: the same
runners, references and readers, with small configurations, mixes and
cells written as new files beside the real ones."""
import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]

TEXT = dict(vocab_size=300, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64, hidden_act="gelu",
            hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
            max_position_embeddings=64, type_vocab_size=2,
            initializer_range=0.02, layer_norm_eps=1e-12)
IMAGE = dict(TEXT, img_dim=48, pos_dim=7)
CAPTIONS = {"dist": "lognormal_int", "median": 10, "sigma": 0.3, "min": 4,
            "max": 30}
REGIONS = {"dist": "uniform_int", "min": 3, "max": 20}
SHARE = 0.8

FILES = {
    "configs/tiny-bi.json": {"name": "tiny-bi", "kind": "bi_encoder",
                             "source": "test", "reduced": [],
                             "project_dim": 16, "text": TEXT,
                             "image": IMAGE},
    "configs/tiny-cross.json": {"name": "tiny-cross",
                                "kind": "cross_encoder", "source": "test",
                                "reduced": [], "model": IMAGE},
    "traffic/tiny_pairs.json": {"runner": "itm_train", "batch": 8,
                                "caption_tokens": CAPTIONS,
                                "regions": REGIONS, "image_share": SHARE,
                                "captions": 64, "images": 32},
    "traffic/tiny_rerank.json": {"runner": "rerank", "queries_per_call": 16,
                                 "candidates": 10, "caption_tokens": CAPTIONS,
                                 "regions": REGIONS, "image_share": SHARE,
                                 "captions": 64, "images": 32},
}


def cell_file(real: str, **override) -> dict:
    """A real cell's file with some keys changed."""
    with open(BENCH_DIR / "workloads" / f"{real}.json") as f:
        d = json.load(f)
    d.update(override)
    return d


CELLS = {
    "tiny.train": ("tiny-bi", "tiny_pairs",
                   cell_file("itm_train.f32", warm_steps=4)),
    "tiny.rerank": ("tiny-cross", "tiny_rerank",
                    cell_file("rerank.f32", check_pairs=32)),
}


def make(tmp: Path, extra_files=None, extra_metrics=()) -> Path:
    """tmp/benchmark (a copy of the real one plus the tiny files) and
    tmp/BENCHMARK.json naming the tiny cells; returns the bench dir."""
    bench = tmp / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    files = dict(FILES)
    for name, (config, traffic, cell) in CELLS.items():
        files[f"workloads/{name}.json"] = cell
    files.update(extra_files or {})
    for rel, body in files.items():
        path = bench / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if isinstance(body, str):
            path.write_text(body)
        else:
            path.write_text(json.dumps(body))
    with open(BENCH_DIR.parent / "BENCHMARK.json") as f:
        doc = json.load(f)
    doc["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                         "why": "test"}
                        for n, (c, t, _) in CELLS.items()]
    doc["end_to_end"] = [dict(m, workloads=["tiny.train"])
                         if m["name"] == "train_pairs_per_s" else
                         dict(m, workloads=["tiny.rerank"])
                         if m["name"] == "rerank_pairs_per_s" else m
                         for m in doc["end_to_end"]]
    doc["per_layer"] = list(extra_metrics)
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return bench
