"""The harness on the CPU at a small size: cells, configurations, mixes and
metrics found as files by name, the import check, the look for a card,
and ``correct`` coming out false when the timed path is broken."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from harness import core
from harness import traffic as T

SEED = 2 ** 31 + 977     # larger than 32 signed bits hold


@pytest.mark.parametrize("names, bad", [
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["lightningdot_tpu", "lightningdot_tpu.models.encoder"],
     ["lightningdot_tpu"]),
    (["lightningdot_tpu_torch", "lightningdot_tpu_torch.models.encoder",
      "jaxtyping", "numpy"], []),
])
def test_import_check(names, bad):
    assert core.forbidden_modules(names) == bad


def test_traffic_grid_is_the_same_for_every_seed():
    spec = {"dist": "lognormal_int", "median": 13.5, "sigma": 0.25,
            "min": 8, "max": 60}
    a = T.sizes(spec, 4096, T.rng(1, 10))
    b = T.sizes(spec, 4096, T.rng(SEED, 10))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert 8 <= a.min() and a.max() <= 60
    assert 13 <= a.mean() <= 15
    caps = T.captions([8, 9], 28996, T.rng(SEED, 1))
    assert [c[0] for c in caps] == [101, 101]
    assert [c[-1] for c in caps] == [102, 102]
    regs = T.regions([10, 100], 2048, T.rng(SEED, 2))
    assert [f.shape for f, _ in regs] == [(10, 2048), (100, 2048)]
    assert all(f.dtype == np.float16 and (f >= 0).all() for f, _ in regs)
    box = regs[0][1].astype(np.float32)
    assert np.allclose(box[:, 2:4] - box[:, :2], box[:, 4:6], atol=2e-3)


@pytest.mark.parametrize("name", list(tiny.CELLS))
def test_cell_added_as_files_runs_correct(bench, name):
    """Each new cell runs on the CPU through the port's plain path and its
    outputs agree with the reference; the new metric is read from its
    file in the traced run."""
    cell = core.Cell(name, bench_dir=bench)
    result, lines, _ = core.run_cell(cell, SEED, 1.0, False, "cpu")
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result)[-1] == "check"
    assert len(lines) == len(result["check"])
    traced, _, _ = core.run_cell(cell, SEED + 1, 0.5, True, "cpu")
    assert traced["metrics"]["calls_counted"]["value"] >= 1
    if name == "tiny.train":        # read from the steps after the window
        assert traced["metrics"]["host_enqueue_ms.train"]["value"] > 0
    else:
        assert "host_enqueue_ms.train" not in traced["metrics"]
    assert {"busy_s", "window_s"} <= set(traced["device"])


def _halve(batch):
    """The first half of a staged ITM batch."""
    n = batch["valid_mask"].shape[0] // 2
    return {k: ({kk: vv[:n] for kk, vv in v.items()} if isinstance(v, dict)
                else v[:n] if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def _plant(monkeypatch, fault):
    from lightningdot_tpu_torch.training import cross_scorer, itm_step, optim
    if fault == "state_unchanged":
        monkeypatch.setattr(optim.FusedAdamW, "step",
                            lambda self: torch.zeros(()))
    elif fault == "half_batch":
        loss_fn = itm_step.itm_loss_fn
        monkeypatch.setattr(itm_step, "itm_loss_fn",
                            lambda model, batch, *a, **k:
                            loss_fn(model, _halve(batch), *a, **k))
    else:
        score = cross_scorer.CrossScorer.score_batch

        def broken(self, batch):
            s = score(self, batch).clone()
            if fault == "score_altered":
                return s + 1.0
            n = s.shape[0] // 2
            s[n:] = s[:n].mean()
            return s
        monkeypatch.setattr(cross_scorer.CrossScorer, "score_batch", broken)


@pytest.mark.parametrize("name, fault", [
    ("tiny.train", "state_unchanged"), ("tiny.train", "half_batch"),
    ("tiny.rerank", "score_altered"), ("tiny.rerank", "half_scores")])
def test_broken_timed_path_is_not_correct(bench, monkeypatch, name, fault):
    _plant(monkeypatch, fault)
    cell = core.Cell(name, bench_dir=bench)
    result, _, _ = core.run_cell(cell, SEED, 1.0, False, "cpu")
    assert not result["correct"], result["check"]


def test_run_without_a_card_prints_no_result(tmp_path):
    """No CUDA device here: the command exits with 2 and prints nothing on
    standard output; in a directory with only the benchmark's own files it
    fails too."""
    root = core.BENCH_DIR.parent
    args = ["--workload", "itm_train.f32", "--seed", str(SEED),
            "--seconds", "1", "--trace", "0"]
    done = subprocess.run([sys.executable, str(root / "benchmark" / "run.py"),
                           *args], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 2 and done.stdout == ""
    import shutil
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    done = subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode != 0 and done.stdout == ""


def test_manifest_names_files_that_exist():
    root = core.BENCH_DIR.parent
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for c in doc["configs"]:
        assert (root / c["file"]).is_file()
    for w in doc["workloads"]:
        cell = core.Cell(w["name"])
        assert cell.runner().run and cell.per_layer and cell.end_to_end
        for m in cell.end_to_end + cell.per_layer:
            assert cell.reader(m["name"]).read


def test_warm_up_takes_one_item_of_each_padded_length():
    caps = [np.zeros(n) for n in (12, 40, 30, 34, 9, 70)]
    assert T.first_of_each_bucket(caps, (32, 64)) == {32: 0, 64: 1}
    assert T.first_of_each_bucket(caps, (16, 32, 48)) == {16: 0, 48: 1,
                                                          32: 2}
