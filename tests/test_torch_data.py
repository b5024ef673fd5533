"""The port's data modules against lamp_tpu.data: BatchStream's combinators
and constructors, the corpus minibatches, the tokenizer and codecs (their
files too, and the native and pure-Python routes), the sampling loop, and
prefetch_to_device on the CPU.

Everything here is host code over numpy: streams, batches, tokens and
codec files are held equal to JAX's exactly. ``autoregressive_inference``
runs a 1-block GPT bridged from lamp_tpu in f32; its greedy tokens equal
JAX's (the logits agree to ~1e-6, and the test's argmaxes are 1e-3 apart
or more).
"""

import filecmp

import jax
import numpy as np
import pytest
import torch

from lamp_tpu import data as jdata
from lamp_tpu import nn as jnn
from lamp_tpu_torch import bridge
from lamp_tpu_torch import data as tdata
from lamp_tpu_torch import native as tnative

from .test_torch_modern import jax_params


def _equal(a, b):
    """Batches of numpy arrays / tensors / tuples compare equal."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _items(x=None):
    rng = np.random.RandomState(0)
    return rng.randn(10, 3).astype(np.float32), rng.randint(0, 4, 10)


def _streams(pkg):
    """Each case's stream of ``pkg`` (lamp_tpu.data or the port's) over
    the same data."""
    x, y = _items()
    f = pkg.from_function(5, lambda i: (x[i:i + 2], y[i:i + 2]))
    g = pkg.from_function(3, lambda i: (x[:i], y[:i]))
    return {
        "map": f.map(lambda b: (b[0] * 2, b[1] + 1)),
        "take": f.take(3),
        "take_past_end": f.take(9),
        "concat": f.concat(g),
        "every_nth": f.every_nth(2, 1),
        "repeat_or_take": g.repeat_or_take(7),
        "without_empty": g.without_empty(),
        "from_full_batch": pkg.from_full_batch(x, y),
        "minibatches_from_full": pkg.minibatches_from_full(
            3, x, y, rng=np.random.default_rng(4), drop_last=False),
        "minibatches_drop_last": pkg.minibatches_from_full(
            4, x, y, rng=np.random.default_rng(5)),
        "from_indices": pkg.from_indices([[0, 3], [9, 1, 2]],
                                         lambda sel: (x[sel], y[sel])),
        "staged_from_indices": pkg.staged_from_indices(
            [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], 2,
            lambda idx: (x[idx], y[idx]),
            lambda bucket, sel: (bucket[0][sel], bucket[1][sel]),
            rng=np.random.default_rng(6)),
    }


@pytest.mark.parametrize("case", sorted(_streams(jdata)))
def test_batch_streams_match_jax(case):
    js, ts = _streams(jdata)[case], _streams(tdata)[case]
    want = js.drain_to_list()
    got = ts.drain_to_list()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _equal(a, b)
    assert ts.length == js.length
    count = ts.fold_left(0, lambda acc, b: acc + len(b[1]))
    assert count == js.fold_left(0, lambda acc, b: acc + len(b[1]))


def test_corpus_minibatches_match_jax():
    corpus = np.frombuffer(b"the quick brown fox jumps over the lazy dog " *
                           9, np.uint8)
    for kw in ({"batches_per_epoch": 4}, {}):
        want = jdata.autoregressive_minibatches_from_corpus(
            corpus, 3, 16, rng=np.random.default_rng(2), **kw)
        got = tdata.autoregressive_minibatches_from_corpus(
            corpus, 3, 16, rng=np.random.default_rng(2), **kw)
        assert len(got) == len(want)
        for (tx, ty), (jx, jy) in zip(got, want):
            assert tx.dtype == np.int32 and tx.shape == (3, 16)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


TEXT = (b"Lamp trains language models; lamp serves them. The 42 models "
        b"train on text and serve text, \xff\xfe bytes too. " * 6)


@pytest.mark.parametrize("route", ["native", "python"])
def test_tokenizer_and_codecs_match_jax(route, tmp_path, monkeypatch):
    """train_bpe, ByteSegmentCodec (encode, decode, save, load) and
    IdentityCodec in both packages, each through the same route (the C++
    library, or the pure-Python code where it is missing): the same
    vocabulary, tokens and codec files. The route decides the order of
    n-grams of equal counts (a dict's insertion order), so a vocabulary
    may differ between routes, in both packages alike; the encoders of the
    two routes give the same tokens for the same vocabulary."""
    from lamp_tpu import native as jnative

    if route == "python":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    else:
        assert tnative.get_lib() is not None
    want = jdata.train_bpe(TEXT, 3, 90)
    got = tdata.train_bpe(TEXT, 3, 90)
    assert got == want
    jc = jdata.ByteSegmentCodec.train(TEXT, 3, 90)
    tc = tdata.ByteSegmentCodec.train(TEXT, 3, 90)
    assert (tc._native is None) == (route == "python")
    probe = TEXT[:120] + b"\x00 unseen \x01"
    toks = tc.encode(probe)
    np.testing.assert_array_equal(toks, jc.encode(probe))
    assert toks.dtype == np.int32 and tc.vocab_size == jc.vocab_size
    assert tc.decode(toks) == jc.decode(toks)
    np.testing.assert_array_equal(tdata.bpe_encode(probe, got, 999),
                                  jdata.bpe_encode(probe, want, 999))
    # the other route's encoder on this vocabulary: the same tokens
    monkeypatch.undo()
    other = (tnative.NativeBpe(tc.encoding).encode(probe, tc.unknown_token)
             if route == "python" else
             tdata.bpe_encode(probe, tc.encoding, tc.unknown_token))
    np.testing.assert_array_equal(other, toks)
    tc.save(str(tmp_path / "t.json"))
    jc.save(str(tmp_path / "j.json"))
    assert filecmp.cmp(tmp_path / "t.json", tmp_path / "j.json",
                       shallow=False)
    back = tdata.ByteSegmentCodec.load(str(tmp_path / "j.json"))
    np.testing.assert_array_equal(back.encode(probe), toks)
    ident = tdata.IdentityCodec()
    np.testing.assert_array_equal(ident.encode(probe),
                                  jdata.IdentityCodec().encode(probe))
    assert ident.decode(ident.encode(probe)) == probe
    ident.save(str(tmp_path / "ti.json"))
    jdata.IdentityCodec().save(str(tmp_path / "ji.json"))
    assert filecmp.cmp(tmp_path / "ti.json", tmp_path / "ji.json",
                       shallow=False)


def test_native_library_builds_into_the_build_directory():
    lib = tnative.get_lib()
    assert lib is not None and "/_build/lamp_native-" in lib._name
    counts = tnative.native_ngram_counts(b"abab", 2)
    assert counts == {b"a": 2, b"b": 2, b"ab": 2, b"ba": 1}


def test_autoregressive_inference_greedy_matches_jax():
    jm = jnn.LanguageModelModule.init(
        vocab_size=61, context_length=12, num_blocks=1, embed_dim=32,
        attention_heads=2, mlp_hidden=128, key=jax.random.PRNGKey(3))
    tm = bridge.load_language_model(jax_params(jm), num_heads=2,
                                    device="cpu")
    prefix = np.random.RandomState(1).randint(0, 61, (2, 5))
    # 9 tokens: the buffer fills at 12 and then slides
    want = jdata.autoregressive_inference(jm, prefix, length=9,
                                          temperature=0)
    got = tdata.autoregressive_inference(tm, prefix, length=9,
                                         temperature=0)
    assert got.dtype == np.int32 and got.shape == (2, 9)
    np.testing.assert_array_equal(got, want)
    sampled = tdata.autoregressive_inference(
        tm, prefix[0], length=4, temperature=1.0,
        generator=torch.Generator().manual_seed(0))
    assert sampled.shape == (1, 4) and (0 <= sampled).all() and \
        (sampled < 61).all()


def test_prefetch_to_cpu_keeps_order_and_raises_stream_errors():
    x, y = _items()
    stream = tdata.minibatches_from_full(3, x, y,
                                         rng=np.random.default_rng(1))
    got = list(tdata.prefetch_to_device(stream, device="cpu", size=1))
    want = list(tdata.minibatches_from_full(3, x, y,
                                            rng=np.random.default_rng(1)))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert isinstance(a[0], torch.Tensor) and a[0].device.type == "cpu"
        _equal(a, b)

    def broken():
        yield (x[:2], y[:2])
        raise RuntimeError("bad shard")

    it = tdata.prefetch_to_device(tdata.BatchStream(broken), device="cpu")
    _equal(next(it), (x[:2], y[:2]))
    with pytest.raises(RuntimeError, match="bad shard"):
        next(it)
    with pytest.raises(NotImplementedError):
        next(tdata.prefetch_to_device(stream, device="cpu", sharding=object()))
