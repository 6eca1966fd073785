"""The port's data substrate against the JAX package's, on the CPU.

``SyntheticCorpus`` and ``TokenStream`` batches equal bit for bit across
``(step, host_index, n_hosts)``, and ``linearise_materialisation`` over
the port's ``CMatEngine`` equal to the reference's over its own, token
for token: on ``lubm_like(4, 30, 6)`` at vocabularies of 4,096 and
128,256 and at one small enough to hash-bucket the constants, with and
without ``max_facts``, and on the training driver's KB
(``launch.train.KB_SHAPE``, 42,950 tokens at 128,256).  The JAX
package's ``TestData`` cases close the file, on the port.
"""

from __future__ import annotations

import numpy as np
import pytest
from numpy.testing import assert_array_equal

from repro import data as jdata
from repro.core import CMatEngine as JCMatEngine
from repro.core.generators import lubm_like as jlubm_like
from repro_torch.core import CMatEngine
from repro_torch.core.generators import lubm_like
from repro_torch.data import (
    DataConfig,
    KBTokenizer,
    SyntheticCorpus,
    TokenStream,
    linearise_materialisation,
)
from repro_torch.launch.train import KB_SHAPE

SMALL_KB = {"n_dept": 4, "n_students": 30, "n_courses": 6}
#: the driver's stream at llama3.2-1b's vocabulary (the reference's count)
DRIVER_TOKENS = 42_950


@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 16, 8, 0), (128_256, 32, 4, 7)])
def test_synthetic_corpus_matches_reference(vocab, seq, batch, seed):
    want = jdata.SyntheticCorpus(jdata.DataConfig(vocab, seq, batch, seed))
    got = SyntheticCorpus(DataConfig(vocab, seq, batch, seed))
    for step in (0, 1, 5, 1000):
        for n_hosts in (1, 2, 4):
            for host in range(n_hosts):
                g = got.batch(step, host, n_hosts)["tokens"]
                w = want.batch(step, host, n_hosts)["tokens"]
                assert g.dtype == w.dtype == np.int32
                assert_array_equal(g, w)


@pytest.mark.parametrize("n_tokens", [40, 64, 1000])
def test_token_stream_matches_reference(n_tokens):
    """Tiling a stream shorter than one batch, one exactly a batch, and
    one of several batches with a remainder."""
    tokens = np.random.default_rng(0).integers(0, 50, n_tokens).astype(np.int32)
    cfg = (50, 8, 8, 0)
    want = jdata.TokenStream(tokens, jdata.DataConfig(*cfg))
    got = TokenStream(tokens, DataConfig(*cfg))
    assert got.n_batches == want.n_batches
    assert_array_equal(got.tokens, want.tokens)
    for step in range(2 * want.n_batches + 1):
        for n_hosts in (1, 2):
            for host in range(n_hosts):
                assert_array_equal(got.batch(step, host, n_hosts)["tokens"],
                                   want.batch(step, host, n_hosts)["tokens"])


def _engines(kb: dict):
    program, dataset, _ = jlubm_like(**kb)
    ref = JCMatEngine(program)
    ref.load(dataset)
    ref.materialise()
    program, dataset, _ = lubm_like(**kb)
    eng = CMatEngine(program, device="cpu")
    eng.load(dataset)
    eng.materialise()
    return ref, eng


@pytest.fixture(scope="module")
def small_kb():
    return _engines(SMALL_KB)


#: 4,096 and 128,256 hold every constant; 40 and 12 hash-bucket them, and
#: 5 leaves no room for a constant past the predicates
@pytest.mark.parametrize("vocab", [4096, 128_256, 40, 12, 5])
@pytest.mark.parametrize("max_facts", [None, 100, 7])
def test_linearisation_matches_reference(small_kb, vocab, max_facts):
    ref, eng = small_kb
    want = jdata.linearise_materialisation(ref, vocab, max_facts)
    got = linearise_materialisation(eng, vocab, max_facts)
    assert got.dtype == want.dtype == np.int32
    assert_array_equal(got, want)
    if max_facts is None:
        assert got.shape == (2916,)


def test_tokenizer_buckets_like_reference():
    for n_constants, vocab in ((10, 100), (500, 100), (97, 100)):
        preds = ["b", "a", "c"]
        want = jdata.KBTokenizer(n_constants, preds, vocab)
        got = KBTokenizer(n_constants, preds, vocab)
        assert (got.pred_of, got.const_base, got.n_buckets) == (
            want.pred_of, want.const_base, want.n_buckets)
        assert [got.constant(c) for c in range(600)] == [want.constant(c) for c in range(600)]


def test_driver_kb_stream_matches_reference():
    """The stream ``launch.train --kb-corpus`` trains on at llama3.2-1b's
    vocabulary."""
    ref, eng = _engines(KB_SHAPE)
    want = jdata.linearise_materialisation(ref, 128_256)
    got = linearise_materialisation(eng, 128_256)
    assert got.shape == want.shape == (DRIVER_TOKENS,)
    assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# the JAX package's TestData, on the port
# --------------------------------------------------------------------- #
class TestData:
    def test_synthetic_determinism_and_sharding(self):
        c = SyntheticCorpus(DataConfig(vocab_size=100, seq_len=16, global_batch=8))
        assert_array_equal(c.batch(3)["tokens"], c.batch(3)["tokens"])  # restart-safe
        h0 = c.batch(3, host_index=0, n_hosts=2)["tokens"]
        h1 = c.batch(3, host_index=1, n_hosts=2)["tokens"]
        assert h0.shape == (4, 16) and h1.shape == (4, 16)
        assert not np.array_equal(h0, h1)

    def test_token_stream_tiling(self):
        stream = TokenStream(np.arange(40, dtype=np.int32),
                             DataConfig(vocab_size=50, seq_len=8, global_batch=2))
        b0 = stream.batch(0)["tokens"]
        assert b0.shape == (2, 8)
        assert b0.max() < 50

    def test_kb_linearisation(self, small_kb):
        tokens = linearise_materialisation(small_kb[1], vocab_size=4096)
        assert tokens.dtype == np.int32
        assert tokens.shape[0] > 0
        assert tokens.min() >= 0 and tokens.max() < 4096
