"""models/embed.py against the JAX package's models/embed.py on the same
texts, tokenizer and (carried) weights: text_encoder and encode_corpus
within 1e-5 (f32; the same f32 formulas summed in other orders), tail
padding included, and a streaming encode → FlatIndex.add that returns the
same neighbours as the JAX package's streaming build."""

import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import synthetic_corpus
from cloudvectordb_tpu.data.tokenize import TextTokenizer as JaxTokenizer
from cloudvectordb_tpu.index.flat import FlatIndex as JaxFlat
from cloudvectordb_tpu.models import embed as jax_embed
from cloudvectordb_tpu.models.encoder import init_encoder as jax_init
from cloudvectordb_tpu.utils.config import EncoderConfig as JaxConfig
from cloudvectordb_tpu_torch.data.tokenize import TextTokenizer
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.models import embed
from cloudvectordb_tpu_torch.models.encoder import Encoder
from cloudvectordb_tpu_torch.models.hf_import import state_dict_from_flax
from cloudvectordb_tpu_torch.utils.config import EncoderConfig


@pytest.fixture(scope="module")
def setup():
    corpus = synthetic_corpus(45, seed=200)
    jtok = JaxTokenizer.train(corpus, vocab_size=512, max_len=16)
    tok = TextTokenizer(jtok._tok, max_len=16)  # the same trained vocabulary
    kw = dict(vocab_size=max(tok.vocab_size, 8), hidden_dim=32, num_layers=1, num_heads=4,
              mlp_dim=64, max_len=16, dropout=0.0, dtype="float32")
    jm, jp = jax_init(JaxConfig(**kw), seed=0)
    cfg = EncoderConfig(**kw)
    model = Encoder(cfg)
    model.load_state_dict(state_dict_from_flax(jp, cfg))
    return corpus, jtok, tok, jm, jp, model


def test_tokenizer_copy_encodes_like_the_reference(setup):
    corpus, jtok, tok, *_ = setup
    for a, b in zip(jtok.encode_batch(corpus[:7]), tok.encode_batch(corpus[:7])):
        np.testing.assert_array_equal(a, b)


def test_text_encoder_and_encode_corpus_match_the_reference(setup):
    corpus, jtok, tok, jm, jp, model = setup
    ref = jax_embed.text_encoder(jm, jp, jtok, batch_size=16)(corpus)
    got = embed.text_encoder(model, tok, batch_size=16, device="cpu")(corpus)
    assert got.shape == (45, 32) and got.dtype == np.float32  # 45 = 2 x 16 + a padded tail
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    got7 = embed.encode_corpus(model, tok, corpus, batch_size=7, device="cpu")
    np.testing.assert_allclose(got7, ref, atol=1e-5, rtol=0)
    assert embed.text_encoder(model, tok, device="cpu")([]).shape == (0, 32)


def test_streaming_insert_gives_the_references_neighbours(setup):
    corpus, jtok, tok, jm, jp, model = setup
    jidx = JaxFlat(32)
    n_ref = jax_embed.encode_corpus_streaming(jm, jp, jtok, corpus, jidx.add, batch_size=16)
    idx = FlatIndex(32, device="cpu")
    seen = []

    def consume(emb):
        seen.append(emb)
        idx.add(emb)

    n = embed.encode_corpus_streaming(model, tok, corpus, consume, batch_size=16, device="cpu")
    assert n == n_ref == 45 and idx.ntotal == 45
    assert all(isinstance(e, torch.Tensor) for e in seen)  # device tensors, not numpy
    q = embed.text_encoder(model, tok, batch_size=16, device="cpu")(corpus[:10])
    _, ids = idx.search(q, 5)
    _, ref_ids = jidx.search(q, 5)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))
    np.testing.assert_array_equal(ids[:, 0], np.arange(10))
