"""The port's data preparation (``lightningdot_tpu_torch.cli.prepro``)
against the JAX package's on tests/test_prepro.py's cases: the same
annotations and region files through both CLIs give the same records, and
each package reads the DBs the other wrote.
"""
import json
import os

import numpy as np
import pytest

from lightningdot_tpu.cli import prepro as jprepro
from lightningdot_tpu.data.feat_db import DetectFeatDb as JDetectFeatDb
from lightningdot_tpu.data.txt_db import TxtTokDb as JTxtTokDb
from lightningdot_tpu_torch.cli import prepro
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb, write_feat_db
from lightningdot_tpu_torch.data.txt_db import TxtTokDb

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "!", "a", "dog",
         "cat", "runs", "on", "the", "beach", "##s", "##ing", "photo",
         "two", "play"]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB))
    return str(p)


def _both(tmp_path, cmds, out_name):
    """Run the port's CLI and JAX's on the same arguments, each into its
    own output; returns (port output, JAX output)."""
    outs = []
    for who, main in (("port", prepro.main), ("jax", jprepro.main)):
        out = str(tmp_path / who / out_name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        main([a.replace("{out}", out) for a in cmds])
        outs.append(out)
    return outs


def _same_txt_dbs(port_out, jax_out):
    """Record for record, side files too, each package reading each DB."""
    dbs = [cls(path, max_txt_len=-1) for cls in (TxtTokDb, JTxtTokDb)
           for path in (port_out, jax_out)]
    ref = dbs[-1]
    for db in dbs:
        assert db.ids == ref.ids
        assert all(db[i] == ref[i] for i in ref.ids)
        assert db.txt2img == ref.txt2img and db.img2txts == ref.img2txts
        assert (db.cls_, db.sep, db.mask) == (ref.cls_, ref.sep, ref.mask)
    for name in ("meta.json", "id2len.json"):
        with open(os.path.join(port_out, name)) as f, \
                open(os.path.join(jax_out, name)) as g:
            assert json.load(f) == json.load(g), name
    return dbs[0]


def test_txt_prepro_itm(vocab_file, tmp_path):
    ann = {"images": [
        {"filename": "1000092795.jpg",
         "sentences": [{"sentid": 0, "raw": "a dog runs"},
                       {"sentid": 1, "raw": "two dogs play"}]},
        {"filename": "10002456.jpg",
         "sentences": [{"sentid": 2, "raw": "a cat on the beach"}]}]}
    ann_path = tmp_path / "flickr.json"
    ann_path.write_text(json.dumps(ann))
    db = _same_txt_dbs(*_both(tmp_path, [
        "txt", "--annotation", str(ann_path), "--output", "{out}",
        "--format", "itm", "--dataset", "flickr", "--vocab", vocab_file],
        "itm_flickr_test.db"))
    assert sorted(db.ids) == ["0", "1", "2"]
    assert db["0"]["img_fname"] == "flickr30k_001000092795.npz"
    assert db["0"]["input_ids"] == [6, 7, 9]
    assert db["1"]["input_ids"] == [16, 7, 13, 17]
    assert sorted(db.img2txts["flickr30k_001000092795.npz"]) == ["0", "1"]
    assert db.cls_ == 2 and db.sep == 3 and db.mask == 4


def test_txt_prepro_coco_captions(vocab_file, tmp_path):
    """The ``caption`` format (COCO caption annotations)."""
    ann = {"annotations": [
        {"id": 11, "image_id": 391895, "caption": "a dog runs on the beach"},
        {"id": 12, "image_id": 391895, "caption": "two cats play"},
        {"id": 13, "image_id": 522418, "caption": "a photo"}]}
    ann_path = tmp_path / "captions.json"
    ann_path.write_text(json.dumps(ann))
    db = _same_txt_dbs(*_both(tmp_path, [
        "txt", "--annotation", str(ann_path), "--output", "{out}",
        "--format", "caption", "--split", "val2014", "--vocab", vocab_file],
        "coco_cap.db"))
    assert db["11"]["img_fname"] == "coco_val2014_000000391895.npz"
    assert sorted(db.img2txts["coco_val2014_000000391895.npz"]) == ["11",
                                                                    "12"]


def test_txt_prepro_conceptual(vocab_file, tmp_path):
    tsv = "\n".join(["0\thttp://x/a.jpg\ta dog runs\tsuccess",
                     "1\thttp://x/b.jpg\tbroken row caption\tfail",
                     "2\thttp://x/c.jpg\ta cat on the beach\tsuccess"])
    ann_path = tmp_path / "cc.tsv"
    ann_path.write_text(tsv)
    db = _same_txt_dbs(*_both(tmp_path, [
        "txt", "--annotation", str(ann_path), "--output", "{out}",
        "--format", "conceptual", "--split", "train", "--vocab",
        vocab_file], "conceptual_train.db"))
    assert sorted(db.ids) == ["0", "2"]
    assert db["2"]["img_fname"] == "gcc_train_000000000002.npz"


def test_txt_prepro_conceptual_img_filter(vocab_file, tmp_path):
    rng = np.random.default_rng(0)
    img_dir = str(tmp_path / "gcc_train")
    rec = {"features": rng.standard_normal((6, 8)).astype(np.float32),
           "norm_bb": rng.random((6, 7)).astype(np.float32),
           "conf": np.linspace(1, 0.5, 6).astype(np.float32)}
    write_feat_db(img_dir, {"gcc_train_000000000002.npz": rec},
                  conf_th=0.2, max_bb=6, min_bb=2, num_bb=4)
    tsv = "\n".join(["0\thttp://x/a.jpg\ta dog runs\tsuccess",
                     "2\thttp://x/c.jpg\ta cat on the beach\tsuccess"])
    ann_path = tmp_path / "cc.tsv"
    ann_path.write_text(tsv)
    db = _same_txt_dbs(*_both(tmp_path, [
        "txt", "--annotation", str(ann_path), "--output", "{out}",
        "--format", "conceptual", "--split", "train", "--vocab",
        vocab_file, "--img_db", img_dir], "conceptual_train.db"))
    assert db.ids == ["2"]


def test_txt_prepro_sbu(vocab_file, tmp_path):
    data = [{"iid": "00042", "sent": "a dog runs",
             "file_path": "0001/1.jpg"},
            {"iid": "bad7", "sent": "a cat on the beach",
             "file_path": "0001/2.jpg"},
            {"iid": "99", "sent": "two dogs play",
             "file_path": "0347/565.jpg"}]
    ann_path = tmp_path / "sbu.json"
    ann_path.write_text(json.dumps(data))
    db = _same_txt_dbs(*_both(tmp_path, [
        "txt", "--annotation", str(ann_path), "--output", "{out}",
        "--format", "sbu", "--vocab", vocab_file], "sbu.db"))
    assert sorted(db.ids) == ["42", "bad7"]
    assert db["42"]["img_fname"] == "sbu_42.npz"


def test_txt_prepro_needs_a_vocab_file(tmp_path):
    """The named tokenizer download is not ported: ``--vocab`` is
    required."""
    ann_path = tmp_path / "a.json"
    ann_path.write_text(json.dumps({"annotations": []}))
    with pytest.raises(ValueError, match="--vocab"):
        prepro.main(["txt", "--annotation", str(ann_path), "--output",
                     str(tmp_path / "o"), "--format", "caption"])


@pytest.mark.parametrize("keep_all", [False, True])
def test_img_prepro_matches_jax(tmp_path, keep_all):
    """npz region files (float32 features downcast to float16, truncated
    to the confident boxes) -> the same feature DB, read by both
    packages."""
    rng = np.random.default_rng(1)
    src = tmp_path / "npz" / "flickr30k"
    os.makedirs(src)
    for i in range(4):
        nbb = 8 + i
        np.savez(src / f"flickr30k_{i:012}.npz",
                 features=rng.standard_normal((nbb, 16)).astype(np.float32),
                 norm_bb=rng.random((nbb, 6)).astype(np.float32),
                 conf=np.linspace(1, 0.01, nbb).astype(np.float32))
    (src / "flickr30k_broken.npz").write_bytes(b"not a zip")
    port_out, jax_out = _both(tmp_path, [
        "img", "--img_dir", str(src), "--output", "{out}", "--conf_th",
        "0.2", "--max_bb", "10", "--min_bb", "4", "--num_bb", "9",
        *(["--keep_all"] if keep_all else [])], "img")
    kw = dict(conf_th=-1 if keep_all else 0.2, max_bb=10, min_bb=4,
              num_bb=9)
    dbs = [cls(os.path.join(path, "flickr30k"), **kw)
           for cls in (DetectFeatDb, JDetectFeatDb)
           for path in (port_out, jax_out)]
    ref = dbs[-1]
    names = [f"flickr30k_{i:012}.npz" for i in range(4)]
    for db in dbs:
        for name in names:
            for a, b in zip(db[name], ref[name]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # (with keep_all the box counts fill in as records are read)
        assert dict(db.name2nbb) == dict(ref.name2nbb)
    if not keep_all:
        feat, _ = dbs[0][names[0]]
        assert feat.shape == (int((np.linspace(1, 0.01, 8) > 0.2).sum()),
                              16)


def test_caption_meta_matches_jax(tmp_path):
    ann = tmp_path / "ann.txt"
    ann.write_text("123.jpg\ta dog runs\n123.jpg\ttwo dogs\n456.jpg\ta cat\n")
    port_out, jax_out = _both(tmp_path, [
        "caption_meta", "--annotation", str(ann), "--output", "{out}",
        "--format", "flickr"], "meta.json")
    meta = json.load(open(port_out))
    assert meta == json.load(open(jax_out))
    assert meta["flickr30k_000000000123.npz"] == ["a dog runs", "two dogs"]
    coco = tmp_path / "coco.json"
    coco.write_text(json.dumps({"annotations": [
        {"image_id": 42, "caption": "a cat"}]}))
    assert prepro.annotation2json(str(coco), "coco") == \
        jprepro.annotation2json(str(coco), "coco")
