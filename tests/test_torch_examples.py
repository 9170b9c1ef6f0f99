"""The port's examples (examples/demo_retrieval_torch.py and
examples/serve_http_torch.py) with ``--device cpu`` at a small width
(hidden 32, 2 layers, 4 heads, vocab 28,996 for the synthetic WordPiece
vocabulary, image features 32 wide), and ``serving.display_img`` against a
stub matplotlib. Rankings are held for equality: the example's answers
against ``Retriever.retrieve_query`` on the same weights and corpus."""
import importlib.util
import json
import sys
import types
import urllib.request
from pathlib import Path
from urllib.parse import quote

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=28996, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_demo_retrieval_answers_as_the_retriever(tmp_path, capsys):
    """``main(['--device', 'cpu'])`` over 12 synthetic images: the top 5 of
    each query, printed, equal ``Retriever.retrieve_query`` on a retriever
    built again from the same seed (corpus encoded by
    ``get_model_encoded_vecs``)."""
    demo = _example("demo_retrieval_torch")
    kw = dict(txt_config=SMALL, img_config=dict(SMALL, img_dim=32),
              compute_dtype=torch.float32)
    got = demo.main(["--device", "cpu", "--n_imgs", "12"], **kw)
    printed = capsys.readouterr().out
    assert "encoded corpus: 12 images on cpu" in printed
    retriever = demo.build(str(tmp_path), device="cpu", n_imgs=12, **kw)
    assert retriever.corpus_size == 12
    assert list(got) == demo.QUERIES
    for query in demo.QUERIES:
        want = retriever.retrieve_query(query, top=5)
        assert got[query] == want, query
        assert len({i for i, _ in want}) == 5
        assert f"1. {want[0][0]}" in printed


def test_serve_http_answers_a_search(tmp_path):
    """``build`` on the CPU, ``RetrievalServer`` on a free port: one
    ``/search?q=...&top=5`` answers the top 5 of a direct
    ``Retriever.retrieve_query``."""
    from lightningdot_tpu_torch.serving_http import RetrievalServer

    serve = _example("serve_http_torch")
    frontend = serve.build(str(tmp_path), device="cpu", corpus=500,
                           config=dict(SMALL, project_dim=0),
                           compute_dtype=torch.float32)
    query = "two dogs play in the park"
    with RetrievalServer(frontend, port=0) as srv:
        url = f"{srv.address}/search?q={quote(query)}&top=5"
        with urllib.request.urlopen(url, timeout=60) as r:
            body = json.loads(r.read())
    assert body["query"] == query
    want = frontend.retriever.retrieve_query(query, top=5)
    assert [tuple(x) for x in body["results"]] == want
    assert frontend.requests_served == 1


def test_display_img_with_a_stub_matplotlib(monkeypatch, capsys):
    """``serving.display_img`` imports matplotlib when called: with stub
    modules it reads the image file, shows it, and prints the annotation
    and the first caption (the JAX function's output)."""
    from lightningdot_tpu_torch.serving import display_img

    calls = []
    mpl = types.ModuleType("matplotlib")
    image = types.ModuleType("matplotlib.image")
    pyplot = types.ModuleType("matplotlib.pyplot")
    image.imread = lambda path: calls.append(("imread", path)) or "pixels"
    pyplot.imshow = lambda img: calls.append(("imshow", img))
    pyplot.show = lambda: calls.append(("show",))
    mpl.image, mpl.pyplot = image, pyplot
    for name, mod in (("matplotlib", mpl), ("matplotlib.image", image),
                      ("matplotlib.pyplot", pyplot)):
        monkeypatch.setitem(sys.modules, name, mod)
    meta = {"img1": {"img_file": "/data/img1.jpg",
                     "annotation": ["dog", "ball"],
                     "caption": ["a dog with a ball", "a pet"]}}
    display_img(meta, "img1")
    assert calls == [("imread", "/data/img1.jpg"), ("imshow", "pixels"),
                     ("show",)]
    assert capsys.readouterr().out == (
        "annotation\n\tdog\n\tball\ncaption\n\ta dog with a ball\n")
    display_img(meta, "img1", img_only=True)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ["demo_retrieval_torch",
                                  "serve_http_torch"])
def test_examples_default_to_the_card(name, monkeypatch, tmp_path):
    """Without ``--device`` the examples run on the card, and raise where
    there is none rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).build(str(tmp_path))
