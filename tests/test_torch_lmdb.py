"""The port's reference-DB ingestion (``lightningdot_tpu_torch.data.
lz4frame``, ``data.lmdb_reader`` and ``cli/prepro.py from-lmdb``) on the
cases of tests/test_lmdb_ingest.py: the committed liblz4 golden frames,
hand-built spec frames, error paths, a fuzz against the system liblz4
where it is installed, LMDB files written by tests/lmdb_fixture.py, and
the converter end to end; each against the JAX package's decoder, reader
or converter on the same bytes.
"""
import base64
import io
import json
import os

import msgpack
import numpy as np
import pytest

from lightningdot_tpu.cli import prepro as jprepro
from lightningdot_tpu.data import lz4frame as jlzf
from lightningdot_tpu.data.feat_db import DetectFeatDb as JDetectFeatDb
from lightningdot_tpu.data.lmdb_reader import PureLmdbReader as JReader
from lightningdot_tpu.data.txt_db import TxtTokDb as JTxtTokDb
from lightningdot_tpu_torch.cli import prepro
from lightningdot_tpu_torch.data import lz4frame as lzf
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.lmdb_reader import (LmdbFormatError,
                                                     PureLmdbReader,
                                                     open_lmdb)
from lightningdot_tpu_torch.data.txt_db import TxtTokDb
from tests.lmdb_fixture import write_lmdb
from tests.test_lmdb_ingest import (_liblz4, _mixed_items, _npz_value,
                                    _ref_txt_lmdb, _stored_frame)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _decoders():
    out = [("pure", lzf._py_decompress)]
    if lzf._native() is not None:
        out.append(("native", lzf.decompress))
    return out


def test_native_decoder_builds():
    """The shared ``native/ldlz4.cc`` builds through the port's loader."""
    assert lzf._native() is not None


def test_xxh32_matches_jax():
    for impl in (lzf._py_xxh32, lzf.xxh32):
        assert impl(b"") == 0x02CC5D05
        assert impl(b"abc") == 0x32D153FF
    blob = bytes(range(256)) * 33
    for seed in (0, 1, 0x9E3779B1):
        assert lzf.xxh32(blob, seed) == lzf._py_xxh32(blob, seed) \
            == jlzf.xxh32(blob, seed)


def test_golden_frames_from_liblz4():
    with open(os.path.join(FIXTURES, "lz4_frames.json")) as f:
        cases = json.load(f)
    assert len(cases) >= 6
    for case in cases:
        want = base64.b64decode(case["input_b64"])
        frame = base64.b64decode(case["frame_b64"])
        assert lzf.content_size(frame) == jlzf.content_size(frame)
        for name, dec in _decoders():
            assert dec(frame) == want, (case["desc"], name)


def test_hand_built_spec_frames():
    for data in (b"", b"x", b"hello " * 999, os.urandom(70000)):
        frame = _stored_frame(data)
        for name, dec in _decoders():
            assert dec(frame) == data, name
    block = bytes([0x54]) + b"abcde" + (1).to_bytes(2, "little")
    assert lzf.block_decompress(block) == b"abcde" + b"e" * 8
    block2 = bytes([0x00]) + (3).to_bytes(2, "little")
    assert lzf.block_decompress(block2, hist=b"xyz") == b"xyzx"


def test_lz4_error_paths():
    with pytest.raises(lzf.Lz4Error):
        lzf._py_decompress(b"\x00\x00\x00\x00garbage")
    frame = _stored_frame(b"hello world")
    with pytest.raises(lzf.Lz4Error):
        lzf._py_decompress(frame[:-6])
    bad = bytearray(frame)
    bad[4 + 2 + 8] ^= 0xFF
    for _, dec in _decoders():
        with pytest.raises(lzf.Lz4Error):
            dec(bytes(bad))
    lie = _stored_frame(b"hello world")
    lied = lie[:6] + (99).to_bytes(8, "little") + lie[14:]
    hc = (lzf._py_xxh32(lied[4:14]) >> 8) & 0xFF
    lied = lied[:14] + bytes([hc]) + lied[15:]
    with pytest.raises(lzf.Lz4Error):
        lzf._py_decompress(lied)


def test_skippable_frames_and_concatenation():
    skip = (0x184D2A50).to_bytes(4, "little") + (4).to_bytes(4, "little") \
        + b"\xde\xad\xbe\xef"
    frame = skip + _stored_frame(b"one") + _stored_frame(b"two")
    for name, dec in _decoders():
        assert dec(frame) == b"onetwo", name


@pytest.mark.skipif(_liblz4() is None, reason="no system liblz4")
def test_fuzz_decoders_vs_system_liblz4_and_jax():
    """Random payloads compressed by the real liblz4 decode to the same
    bytes through the port's decoders and JAX's."""
    import ctypes

    lib = _liblz4()

    def compress(data):
        bound = lib.LZ4F_compressFrameBound(len(data), None)
        dst = ctypes.create_string_buffer(bound)
        got = lib.LZ4F_compressFrame(dst, bound, data, len(data), None)
        assert not lib.LZ4F_isError(got)
        return dst.raw[:got]

    rng = np.random.default_rng(321)
    for trial in range(30):
        kind = trial % 3
        size = int(rng.integers(0, 150000))
        if kind == 0:
            data = bytes(rng.integers(0, 4, size, dtype=np.uint8))
        elif kind == 1:
            data = msgpack.dumps(
                {"input_ids": rng.integers(0, 30000, size % 500).tolist(),
                 "img_fname": "x" * (size % 64)}, use_bin_type=True)
        else:
            data = rng.bytes(size)
        frame = compress(data)
        assert jlzf.decompress(frame) == data
        for name, dec in _decoders():
            assert dec(frame) == data, (trial, name, size)


def test_pure_reader_matches_jax(tmp_path):
    items = _mixed_items()
    write_lmdb(str(tmp_path / "db"), items)
    with PureLmdbReader(str(tmp_path / "db")) as r, \
            JReader(str(tmp_path / "db")) as jr:
        assert len(r) == len(jr) == len(items)
        got = dict(r.items())
        assert got == items and list(got) == list(dict(jr.items()))
        keys = sorted(items)
        for k in keys[::29] + [keys[0], keys[-1]]:
            assert r.get(k) == jr.get(k) == items[k]
        assert r.get(b"absent") is None
        assert r.get(keys[0] + b"x") is None


def test_pure_reader_deep_tree_and_edge_cases(tmp_path):
    deep = {(b"k%05d" % i) * 40: (b"v%d" % i) * 30 for i in range(1500)}
    write_lmdb(str(tmp_path / "deep"), deep)
    with PureLmdbReader(str(tmp_path / "deep")) as r:
        assert r.main.depth >= 3
        assert dict(r.items()) == deep
        for k in sorted(deep)[::171]:
            assert r.get(k) == deep[k]
    write_lmdb(str(tmp_path / "empty"), {})
    with PureLmdbReader(str(tmp_path / "empty")) as r:
        assert len(r) == 0 and list(r.items()) == [] \
            and r.get(b"x") is None
    write_lmdb(str(tmp_path / "one"), {b"a": b"1"})
    with PureLmdbReader(str(tmp_path / "one")) as r:
        assert dict(r.items()) == {b"a": b"1"}


def test_reader_rejects_garbage_and_selects_a_backend(tmp_path):
    p = tmp_path / "bad"
    p.mkdir()
    (p / "data.mdb").write_bytes(b"\x00" * 16384)
    with pytest.raises(LmdbFormatError):
        PureLmdbReader(str(p))
    write_lmdb(str(tmp_path / "db"), {b"a": b"1"})
    r = open_lmdb(str(tmp_path / "db"), backend="pure")
    assert isinstance(r, PureLmdbReader)
    r.close()
    with pytest.raises(ValueError, match="unknown backend"):
        open_lmdb(str(tmp_path / "db"), backend="other")
    try:
        import lmdb  # noqa: F401
    except ImportError:
        assert isinstance(open_lmdb(str(tmp_path / "db")), PureLmdbReader)
        with pytest.raises(ImportError):
            open_lmdb(str(tmp_path / "db"), backend="package")


def test_convert_txt_lmdb_matches_jax(tmp_path):
    src = str(tmp_path / "ref.db")
    id2len, txt2img = _ref_txt_lmdb(src)
    outs = []
    for who, main in (("port", prepro.main), ("jax", jprepro.main)):
        out = str(tmp_path / f"{who}.db")
        main(["from-lmdb", "--kind", "txt", "--src", src, "--output", out])
        outs.append(out)
    dbs = [cls(path, max_txt_len=60) for cls in (TxtTokDb, JTxtTokDb)
           for path in outs]
    with PureLmdbReader(src) as r:
        recs = {k.decode(): msgpack.loads(lzf.decompress(bytes(v)),
                                          raw=False) for k, v in r.items()}
    for db in dbs:
        assert db.id2len == id2len and db.txt2img == txt2img
        assert db.cls_ == 101 and db.sep == 102 and db.mask == 103
        assert all(db[k] == rec for k, rec in recs.items())
    combined = dbs[0].combine_inputs(dbs[0][dbs[0].ids[0]]["input_ids"])
    assert combined[0] == 101 and combined[-1] == 102


def test_convert_txt_rejects_wrong_kind(tmp_path):
    src = str(tmp_path / "ref_img.db")
    write_lmdb(src, {b"a.npz": _stored_frame(msgpack.dumps([1, 2, 3]))})
    with pytest.raises(ValueError, match="wrong --kind"):
        prepro.convert_lmdb_txt(src, str(tmp_path / "o"))


def test_convert_img_lmdb_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    fnames = [f"coco_val2014_{i:012d}.npz" for i in range(6)]
    items = {f.encode(): _npz_value(rng, int(rng.integers(12, 40)))
             for f in fnames}
    items[b"__keys__"] = json.dumps(fnames).encode()
    src = str(tmp_path / "feat_th0.2_max100_min10_compressed")
    write_lmdb(src, items)
    outs = []
    for who, main in (("port", prepro.main), ("jax", jprepro.main)):
        out = str(tmp_path / f"{who}_img")
        main(["from-lmdb", "--kind", "img", "--src", src, "--output", out])
        outs.append(out)
    dbs = [cls(path, conf_th=0.2, max_bb=100, min_bb=10)
           for cls in (DetectFeatDb, JDetectFeatDb) for path in outs]
    for f in fnames:
        src_arrays = dict(np.load(io.BytesIO(items[f.encode()])))
        want_nbb = min(100, max(10, int((src_arrays["conf"] > 0.2).sum())))
        for db in dbs:
            assert db.name2nbb[f] == want_nbb
            feat, _ = db[f]
            np.testing.assert_array_equal(
                np.asarray(feat),
                src_arrays["features"][:want_nbb].astype(np.float32))
    assert "__keys__" not in dbs[0].name2nbb


def test_convert_img_msgpack_numpy_records(tmp_path):
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((20, 16)).astype(np.float16)
    bb = rng.random((20, 6)).astype(np.float16)
    conf = rng.random(20).astype(np.float32)

    def mn(arr):
        return {b"nd": True, b"type": arr.dtype.str.encode(),
                b"kind": b"", b"shape": list(arr.shape),
                b"data": arr.tobytes()}

    rec = msgpack.dumps({b"features": mn(feats), b"norm_bb": mn(bb),
                         b"conf": mn(conf)})
    src = str(tmp_path / "feat_th0.2_max100_min10")
    write_lmdb(src, {b"img_0.npz": rec})
    out = str(tmp_path / "img_out")
    prepro.convert_lmdb_img(src, out)
    db = DetectFeatDb(out, conf_th=0.2, max_bb=100, min_bb=10)
    feat, _ = db["img_0.npz"]
    nbb = db.name2nbb["img_0.npz"]
    np.testing.assert_array_equal(np.asarray(feat),
                                  feats[:nbb].astype(np.float32))


def test_convert_img_param_parsing(tmp_path):
    rng = np.random.default_rng(2)
    src = str(tmp_path / "feat_th0.5_max36_min4_compressed")
    write_lmdb(src, {b"x.npz": _npz_value(rng, 30)})
    out = str(tmp_path / "o")
    prepro.convert_lmdb_img(src, out)
    assert os.path.exists(os.path.join(out, "nbb_th0.5_max36_min4.json"))
    src2 = str(tmp_path / "feat_numbb36")
    write_lmdb(src2, {b"x.npz": _npz_value(rng, 40)})
    prepro.convert_lmdb_img(src2, str(tmp_path / "o2"))
    assert os.path.exists(os.path.join(str(tmp_path / "o2"),
                                       "feat_numbb36.ldkv"))
