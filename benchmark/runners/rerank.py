"""Stage 2 of ``cli/rerank.py``: the cross-encoder scores each query's
candidates through ``training/cross_scorer.py::CrossScorer.score_pairs``,
in its default blocks of pairs, each block staged through pinned buffers
and launched without waiting; the scores are pulled once a call.

A call scores ``queries_per_call`` text->image queries, each a caption
with its ``candidates`` images (its own image first, then distinct others
drawn from the seed), as the CLI's pass over a split does. Set-up scores
``warm_calls`` calls and then one block at each further text length the
pool's captions pad to, so that every shape of the window is warm. After the
window, with the program freed, the reference (``reference/
cross_encoder.py``) scores a sample of the window's pairs, drawn from the
seed with the longest joint sequence in it, and the gaps are compared.
"""
from __future__ import annotations

import numpy as np
import torch

from harness import gaps, program
from harness import traffic as T
from harness import weights
from reference import cross_encoder as ref
from reference.bert import Precision

REF_BLOCK = 128     # pairs the reference scores at once


class Pool:
    """Captions, images and each caption's candidate images."""

    def __init__(self, seed: int, cfg: dict, tr: dict, device):
        gen = T.rng(seed, 20)
        c = cfg["model"]
        self.caps = T.captions(T.sizes(tr["caption_tokens"], tr["captions"],
                                       gen), c["vocab_size"], gen)
        self.regs = T.regions(T.sizes(tr["regions"], tr["images"], gen),
                              c["img_dim"], gen,
                              tr["image_share"], device)
        n_img, k = len(self.regs), tr["candidates"]
        own = np.arange(len(self.caps)) % n_img
        others = np.stack([gen.choice(n_img - 1, k - 1, replace=False)
                           for _ in self.caps])
        others += others >= own[:, None]          # skip the own image
        self.cands = np.concatenate([own[:, None], others], axis=1)
        self.q = tr["queries_per_call"]

    def call(self, k: int):
        """Call ``k``'s pairs as (caption, image) index pairs."""
        qs = np.arange(k * self.q, (k + 1) * self.q) % len(self.caps)
        return [(int(q), int(i)) for q in qs for i in self.cands[q]]

    def inputs(self, pairs):
        return ([self.caps[c] for c, _ in pairs],
                [self.regs[i][0] for _, i in pairs],
                [self.regs[i][1] for _, i in pairs])


def reference_scores(pool: Pool, pairs, state, cfg, prec, device):
    out = []
    for st in range(0, len(pairs), REF_BLOCK):
        part = pairs[st:st + REF_BLOCK]
        caps = [pool.caps[c] for c, _ in part]
        regs = [pool.regs[i] for _, i in part]
        out.append(ref.rank_scores(state, caps, regs, cfg, prec,
                                   device).cpu())
    return torch.cat(out).double().numpy()


def numbers(got: np.ndarray, want: np.ndarray) -> dict:
    """The widest score gap against the peak score, and against the spread
    of the scores once each side's mean is taken out."""
    return {"score_gap": gaps.peak_gap(got, want),
            "centered_gap": gaps.centered_rows(got[:, None], want[:, None])}


def sample(pool: Pool, pairs, n: int, seed: int):
    """``n`` of ``pairs`` drawn from the seed, the longest joint sequence
    among them."""
    gen = T.rng(seed, 21)
    idx = set(gen.choice(len(pairs), min(n, len(pairs)),
                         replace=False).tolist())
    idx.add(max(range(len(pairs)), key=lambda j: len(
        pool.caps[pairs[j][0]]) + pool.regs[pairs[j][1]][0].shape[0]))
    return sorted(idx)


def _initial_state(run):
    c = run.config
    return weights.make_state(ref.layout(c), run.seed, run.device,
                              c["model"]["initializer_range"])


def run(run) -> dict:
    from lightningdot_tpu_torch.training.cross_scorer import CrossScorer

    cfg, tr, job = run.config, run.traffic, run.settings
    pool = Pool(run.seed, cfg, tr, run.device)
    model = program.cross_encoder(cfg, job["compute_dtype"], run.seed,
                                  run.device)
    scorer = CrossScorer(model, device=run.device)
    blocks, padded = [], set()
    make_block = scorer.block

    def observed_block(*args):
        host = make_block(*args)
        blocks.append(host["attn_masks"].shape)
        padded.add(host["input_ids"].shape[1])
        return host

    scorer.block = observed_block       # records the launched shapes

    def one(k: int):
        pairs = pool.call(k)
        toks, feats, boxes = pool.inputs(pairs)
        blocks.clear()
        with run.spans("score"):
            scores = scorer.score_pairs(toks, feats, boxes)
        return pairs, scores

    for k in range(job["warm_calls"]):
        one(k)
    # one block at each further text length the pool's captions pad to
    for length, c in sorted(T.first_of_each_bucket(
            pool.caps, scorer.txt_buckets).items()):
        if length not in padded:
            scorer.score_pairs(*pool.inputs(
                [(c, int(i)) for i in pool.cands[c]]))
    run.setup_done()

    done = []
    k = job["warm_calls"]
    with run.window():
        while run.running():
            pairs, scores = one(k)
            done.append((pairs, scores))
            run.calls.append({
                "blocks": list(blocks),
                "pairs": [(len(pool.caps[c]), pool.regs[i][0].shape[0])
                          for c, i in pairs]})
            run.count(pairs=len(pairs), calls=1)
            k += 1
    del scorer, model
    program.release(run.device)

    pairs = [p for ps, _ in done for p in ps]
    scores = np.concatenate([s for _, s in done]) if done else np.zeros(0)
    failed = int(np.sum(~np.isfinite(scores)))
    if not pairs:
        return {"attempted": 0, "failed": 0, "check": {}}
    idx = sample(pool, pairs, job["check_pairs"], run.seed)
    want = reference_scores(pool, [pairs[j] for j in idx],
                            _initial_state(run), cfg, Precision("f32"),
                            run.device)
    found = numbers(scores[idx].astype(np.float64), want)
    return {"attempted": len(pairs), "failed": failed,
            "check": {k: (v, job["limits"][k]) for k, v in found.items()}}


def control(run) -> dict:
    """The readings of the control (the reference with every product's
    operands in TF32) against the float32 reference, on a sample of the
    first calls' pairs drawn from this run's seed."""
    cfg, tr, job = run.config, run.traffic, run.settings
    pool = Pool(run.seed, cfg, tr, run.device)
    pairs = [p for k in range(job["warm_calls"], job["warm_calls"] + 3)
             for p in pool.call(k)]
    pairs = [pairs[j] for j in sample(pool, pairs, job["check_pairs"],
                                      run.seed)]
    state = _initial_state(run)
    base = reference_scores(pool, pairs, state, cfg, Precision("f32"),
                            run.device)
    return {"tf32": numbers(reference_scores(pool, pairs, state, cfg,
                                             Precision("tf32"), run.device),
                            base)}
