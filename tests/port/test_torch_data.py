"""The data layer against the JAX package's on the same inputs: the
synthetic generators and SIFT-format readers (equal outputs), corpus
streaming and chunking over the synthetic, .txt and .jsonl sources (equal
passages), the hf: source without ``datasets`` (the same exception), and
triplet mining (identical triplets, byte-identical saved files), hard
mining through each package's FlatIndex (identical triplets), and the
tokenized batch stream over one shared tokenizer.json (identical batches)."""

import json
import sys

import numpy as np
import pytest

from cloudvectordb_tpu.data import corpus as jcorpus
from cloudvectordb_tpu.data import synthetic as jsyn
from cloudvectordb_tpu.data import triplets as jtrip
from cloudvectordb_tpu.data.tokenize import TextTokenizer as JaxTokenizer
from cloudvectordb_tpu.index.flat import FlatIndex as JaxFlat
from cloudvectordb_tpu.utils.config import DataConfig as JaxDataConfig
from cloudvectordb_tpu.utils.config import MiningConfig as JaxMiningConfig
from cloudvectordb_tpu_torch.data import corpus, synthetic, triplets
from cloudvectordb_tpu_torch.data.tokenize import TextTokenizer
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex
from cloudvectordb_tpu_torch.utils.config import DataConfig, MiningConfig


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_corpus_is_the_references(seed):
    assert synthetic.synthetic_corpus(120, seed=seed) == jsyn.synthetic_corpus(120, seed=seed)


@pytest.mark.parametrize("kw", [dict(), dict(latent_dim=8, normalize=True),
                                dict(n_clusters=5, cluster_std=0.2, dtype=np.float64)])
def test_clustered_vectors_and_queries_are_the_references(kw):
    x = synthetic.clustered_vectors(500, 24, seed=3, **kw)
    ref = jsyn.clustered_vectors(500, 24, seed=3, **kw)
    assert x.dtype == ref.dtype
    np.testing.assert_array_equal(x, ref)
    for qkw in (dict(), dict(noise=0.5, normalize=True)):
        np.testing.assert_array_equal(synthetic.queries_from(x, 40, seed=5, **qkw),
                                      jsyn.queries_from(ref, 40, seed=5, **qkw))


def test_fvecs_ivecs_fixture_reads_as_the_reference(tmp_path):
    """An .fvecs/.ivecs pair made here from a seed (SIFT's layout: an int32
    dim, then the row), read whole and cut by max_rows."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(37, 16)).astype(np.float32)
    gt = rng.integers(0, 37, size=(9, 10)).astype(np.int32)
    fv = tmp_path / "base.fvecs"
    iv = tmp_path / "gt.ivecs"
    np.concatenate([np.full((37, 1), 16, np.int32), base.view(np.int32)], 1).tofile(fv)
    np.concatenate([np.full((9, 1), 10, np.int32), gt], 1).tofile(iv)
    for max_rows in (None, 5):
        x = synthetic.read_fvecs(fv, max_rows=max_rows)
        np.testing.assert_array_equal(x, jsyn.read_fvecs(fv, max_rows=max_rows))
        np.testing.assert_array_equal(x, base[:max_rows])
        g = synthetic.read_ivecs(iv, max_rows=max_rows)
        np.testing.assert_array_equal(g, jsyn.read_ivecs(iv, max_rows=max_rows))
        np.testing.assert_array_equal(g, gt[:max_rows])


@pytest.mark.parametrize("max_words,stride", [(100, 80), (50, 50), (40, 90), (600, 10)])
def test_chunk_document_is_the_references(max_words, stride):
    """stride > max_words is clamped: no word between windows is lost."""
    text = " ".join(f"w{i}" for i in range(500))
    chunks = corpus.chunk_document(text, max_words=max_words, stride=stride)
    assert chunks == jcorpus.chunk_document(text, max_words=max_words, stride=stride)
    assert len({w for c in chunks for w in c.split()}) == 500


def _sources(tmp_path):
    rng = np.random.default_rng(2)
    docs = [" ".join(f"t{int(v)}" for v in rng.integers(0, 50, size=n))
            for n in rng.integers(3, 400, size=25)]
    txt = tmp_path / "docs.txt"
    txt.write_text("\n\n".join(docs) + "\n")  # blank lines are skipped
    jl = tmp_path / "docs.jsonl"
    jl.write_text("".join(json.dumps({"body": d, "id": i}) + "\n" for i, d in enumerate(docs)))
    return {"synthetic": dict(corpus="synthetic", num_docs=60, seed=4),
            "txt": dict(corpus=f"file:{txt}", num_docs=20),
            "jsonl": dict(corpus=f"file:{jl}", text_field="body", num_docs=0)}


@pytest.mark.parametrize("source", ["synthetic", "txt", "jsonl"])
@pytest.mark.parametrize("chunk", [True, False])
def test_stream_corpus_is_the_references(tmp_path, source, chunk):
    kw = dict(_sources(tmp_path)[source], chunk_long_docs=chunk, chunk_stride=150)
    got = list(corpus.stream_corpus(DataConfig(**kw)))
    assert got == list(jcorpus.stream_corpus(JaxDataConfig(**kw)))
    passages, doc_ids = corpus.load_passages(DataConfig(**kw))
    assert (passages, doc_ids) == jcorpus.load_passages(JaxDataConfig(**kw))
    if source != "synthetic" and chunk:
        assert len(passages) > len(set(doc_ids))  # long documents were chunked


def test_hf_source_without_datasets_raises_as_the_reference(monkeypatch):
    """``datasets`` made unimportable (nothing is downloaded either way)."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    kw = dict(corpus="hf:some/corpus:cfg", num_docs=3)
    with pytest.raises(ImportError) as ref:
        list(jcorpus.stream_corpus(JaxDataConfig(**kw)))
    with pytest.raises(ImportError) as got:
        list(corpus.stream_corpus(DataConfig(**kw)))
    assert type(got.value) is type(ref.value)
    with pytest.raises(ValueError):
        list(corpus.stream_corpus(DataConfig(corpus="ftp:x")))


@pytest.mark.parametrize("num_triplets", [64, 300])
def test_inbatch_mining_is_the_references_byte_for_byte(tmp_path, num_triplets):
    passages = jsyn.synthetic_corpus(90, seed=1)
    doc_ids = [i // 3 for i in range(90)]  # three passages a document
    got = triplets.mine_triplets(passages, doc_ids,
                                 MiningConfig(num_triplets=num_triplets, seed=5))
    ref = jtrip.mine_triplets(passages, doc_ids,
                              JaxMiningConfig(num_triplets=num_triplets, seed=5))
    assert (got.anchors, got.positives, got.negatives) == (
        ref.anchors, ref.positives, ref.negatives)
    got.save(tmp_path / "port.jsonl")
    ref.save(tmp_path / "ref.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
    back = triplets.Triplets.load(tmp_path / "ref.jsonl")
    assert (back.anchors, back.positives, back.negatives) == (
        ref.anchors, ref.positives, ref.negatives)


def test_pairs_fixture_and_pair_mining_are_the_references(tmp_path):
    """load_pairs over a JSONL fixture (a blank line and custom fields), and
    mine_triplets_from_pairs with fewer, as many and more triplets than
    pairs (more oversample with replacement)."""
    rng = np.random.default_rng(8)
    p = tmp_path / "pairs.jsonl"
    lines = [json.dumps({"q": f"query {i} {int(rng.integers(99))}", "pos": f"passage {i}"})
             for i in range(30)]
    p.write_text("\n".join(lines[:10]) + "\n\n" + "\n".join(lines[10:]) + "\n")
    qs, ps = triplets.load_pairs(p, query_field="q", positive_field="pos")
    assert (qs, ps) == jtrip.load_pairs(p, query_field="q", positive_field="pos")
    assert len(qs) == 30
    for n in (0, 12, 30, 75):
        got = triplets.mine_triplets_from_pairs(qs, ps, MiningConfig(num_triplets=n, seed=2))
        ref = jtrip.mine_triplets_from_pairs(qs, ps, JaxMiningConfig(num_triplets=n, seed=2))
        assert len(got) == (n or 30)
        assert (got.anchors, got.positives, got.negatives) == (
            ref.anchors, ref.positives, ref.negatives)


@pytest.fixture(scope="module")
def shared_tokenizer(tmp_path_factory):
    """ONE trained tokenizer.json loaded by both packages: WordPiece
    training is not deterministic from run to run, so two trainings may
    give two vocabularies."""
    passages = jsyn.synthetic_corpus(80, seed=6)
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    JaxTokenizer.train(passages, vocab_size=512, max_len=16).save(path)
    return passages, JaxTokenizer.load(path, 16), TextTokenizer.load(path, 16)


def test_triplet_batches_are_the_references_and_skip_equals_consume(shared_tokenizer):
    passages, jtok, tok = shared_tokenizer
    doc_ids = list(range(len(passages)))
    trip = triplets.mine_triplets(passages, doc_ids, MiningConfig(num_triplets=50, seed=1))
    jt = jtrip.Triplets(trip.anchors, trip.positives, trip.negatives)
    got = list(triplets.triplet_batches(trip, tok, 8, 16, seed=3, epochs=2))
    ref = list(jtrip.triplet_batches(jt, jtok, 8, 16, seed=3, epochs=2))
    assert len(got) == len(ref) == 12  # 6 a epoch (drop remainder), two epochs
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in r:
            np.testing.assert_array_equal(g[key], r[key])
    it = triplets.triplet_batches(trip, tok, 8, 16, seed=3, epochs=2)
    it.skip(9)  # across the epoch boundary
    for key, v in next(it).items():
        np.testing.assert_array_equal(v, got[9][key])
    with pytest.raises(ValueError):
        triplets.triplet_batches(trip, tok, 64, 16)


def _lookup_encoder(passages, emb):
    row = {p: i for i, p in enumerate(passages)}
    return lambda texts: emb[[row[t] for t in texts]]


def test_hard_mining_through_each_packages_flat_index_is_the_references():
    passages = jsyn.synthetic_corpus(300, seed=9)
    doc_ids = [i // 2 for i in range(300)]
    emb = jsyn.clustered_vectors(300, 32, n_clusters=12, seed=4, normalize=True)
    encode_fn = _lookup_encoder(passages, emb)
    cfg = dict(strategy="hard", num_triplets=700, hard_topk=40, hard_skip=1, seed=3)
    got = triplets.mine_triplets(passages, doc_ids, MiningConfig(**cfg), encode_fn=encode_fn,
                                 index=FlatIndex.build(emb, device="cpu"))
    ref = jtrip.mine_triplets(passages, doc_ids, JaxMiningConfig(**cfg), encode_fn=encode_fn,
                              index=JaxFlat.build(emb))
    assert (got.anchors, got.positives, got.negatives) == (
        ref.anchors, ref.positives, ref.negatives)
    with pytest.raises(ValueError):
        triplets.mine_triplets(passages, doc_ids, MiningConfig(**cfg))


@pytest.mark.parametrize("kind", ["flat", "ivf_flat"])
def test_hard_mining_never_picks_an_unfilled_slot(kind):
    """An index of fewer rows than hard_topk: the IVF-Flat search fills
    the slots past its 40 rows with (-inf, -1). Every negative is a filled
    candidate of its anchor's search from another document (the anchors
    are mine_triplets' first draw, replayed here)."""
    passages = jsyn.synthetic_corpus(40, seed=12)
    doc_ids = list(range(40))
    emb = jsyn.clustered_vectors(40, 16, n_clusters=4, seed=1, normalize=True)
    index = (FlatIndex.build(emb, device="cpu") if kind == "flat" else
             IVFFlatIndex.build(emb, 4, kmeans_iters=3, device="cpu"))
    cfg = MiningConfig(strategy="hard", num_triplets=400, hard_topk=100, seed=6)
    trip = triplets.mine_triplets(passages, doc_ids, cfg,
                                  encode_fn=_lookup_encoder(passages, emb), index=index)
    picks = np.random.default_rng(cfg.seed).integers(0, 40, size=cfg.num_triplets)
    scores, ids = index.search(emb[picks], cfg.hard_topk)
    if kind == "ivf_flat":
        assert (ids == -1).any() and not np.isfinite(scores[ids == -1]).any()
    row = {p: i for i, p in enumerate(passages)}
    for t, neg in enumerate(trip.negatives):
        ok = {int(c) for s, c in zip(scores[t, 1:], ids[t, 1:])
              if np.isfinite(s) and c >= 0 and c != picks[t]}
        assert row[neg] in ok
