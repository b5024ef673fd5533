"""lamp_tpu_torch.data.hf_tokenizer against lamp_tpu.data.hf_tokenizer and
the ``tokenizers`` library, on the fixtures of tests/test_hf_tokenizer.py
(a byte-level BPE and a Metaspace BPE trained by ``tokenizers``).

The port's one change is the GPT-2 split: a hand-written scanner in place
of the ``regex`` package's pattern. A hypothesis test holds the scanner
to ``regex.findall`` of the JAX module's ``_GPT2_SPLIT`` over text that
mixes letters, digits, marks, punctuation, CJK, emoji, contractions and
every kind of whitespace and control character; the characters are drawn
from those assigned in the Unicode version of ``unicodedata`` (the two
packages' tables differ only at code points that later versions
assigned). Every comparison is exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

tokenizers = pytest.importorskip("tokenizers")
regex = pytest.importorskip("regex")

import unicodedata  # noqa: E402

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,  # noqa: E402
                        trainers)

from lamp_tpu.data.hf_tokenizer import _GPT2_SPLIT  # noqa: E402
from lamp_tpu.data.hf_tokenizer import HFTokenizer as JaxTokenizer  # noqa: E402
from lamp_tpu_torch.data import HFTokenizer  # noqa: E402
from lamp_tpu_torch.data.hf_tokenizer import gpt2_split  # noqa: E402

from .test_hf_tokenizer import CORPUS, TESTS  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _train(kind, path):
    if kind == "byte_level":
        tok = Tokenizer(models.BPE(unk_token=None))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        tr = trainers.BpeTrainer(
            vocab_size=400, special_tokens=["<|end|>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    else:
        tok = Tokenizer(models.BPE(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.decoder = decoders.Metaspace()
        tr = trainers.BpeTrainer(vocab_size=300,
                                 special_tokens=["<unk>", "<s>", "</s>"])
    tok.train_from_iterator(CORPUS * 20, tr)
    tok.save(path)
    return tok


@pytest.fixture(scope="module", params=["byte_level", "metaspace"])
def fixture(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / f"{request.param}.json")
    oracle = _train(request.param, path)
    return (request.param, path, oracle, HFTokenizer.from_file(path),
            JaxTokenizer.from_file(path))


def test_encode_decode_match_jax_and_tokenizers(fixture):
    kind, _, oracle, ours, jax_tok = fixture
    assert ours.mode == jax_tok.mode == kind
    for s in TESTS + ["x's 'll ''d   　tab\t\n\n end  "]:
        ids = ours.encode(s)
        assert ids == jax_tok.encode(s) == oracle.encode(s).ids, repr(s)
        assert ours.decode(ids) == jax_tok.decode(ids) == oracle.decode(ids)
        assert ours.decode(ids, skip_special_tokens=False) == \
            jax_tok.decode(ids, skip_special_tokens=False)
    assert ours.vocab_size == jax_tok.vocab_size
    assert ours.token_bytes() == jax_tok.token_bytes()


def test_special_tokens_and_token_bytes(fixture):
    kind, _, _, ours, jax_tok = fixture
    special = "<|end|>" if kind == "byte_level" else "</s>"
    ids = ours.encode(f"hi {special} there")
    assert ids == jax_tok.encode(f"hi {special} there")
    assert ours.added[special] in ids
    assert special not in ours.decode(ids)
    assert special in ours.decode(ids, skip_special_tokens=False)
    tb = ours.token_bytes()
    assert len(tb) == ours.vocab_size and tb[ours.added[special]] == b""
    if kind == "byte_level":
        s = "Hello, world! 123"
        assert b"".join(tb[i] for i in ours.encode(s)).decode() == s


def test_byte_fallback_metaspace():
    """Llama-style byte fallback: unknown characters emit <0xNN> tokens."""
    vocab = {"<unk>": 0, "▁": 1, "a": 2, "b": 3, "▁ab": 4}
    vocab.update({f"<0x{i:02X}>": 5 + i for i in range(256)})
    spec = {
        "model": {"type": "BPE", "vocab": vocab,
                  "merges": ["▁ a", "▁a b"], "unk_token": "<unk>",
                  "byte_fallback": True},
        "pre_tokenizer": {"type": "Metaspace"},
        "decoder": {"type": "Metaspace"},
        "added_tokens": [{"id": 0, "content": "<unk>", "special": True}],
    }
    ours, theirs = HFTokenizer(spec), JaxTokenizer(spec)
    for s in ("ab é", "é東", "ab ab"):
        ids = ours.encode(s)
        assert ids == theirs.encode(s)
        assert ours.decode(ids) == theirs.decode(ids) == s
    ids = ours.encode("ab é")
    assert ids[0] == vocab["▁ab"]
    assert vocab["<0xC3>"] in ids and vocab["<0xA9>"] in ids
    assert ours.token_bytes() == theirs.token_bytes()


def test_rejects_non_bpe():
    with pytest.raises(ValueError, match="BPE"):
        HFTokenizer({"model": {"type": "Unigram", "vocab": []}})


_GPT2 = regex.compile(_GPT2_SPLIT)
# every kind of character the split tells apart, and the ones around it
_PIECES = (list("abcXYZsStldrevm'’\"!?.,;:-_()[]{}#@$%&*+/\\<>=~`^|"
                "0123456789٣٤൧²½Ⅻ")
           + ["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "''s"]
           + list("éñßøΩЖж東京日本語한국어αβγ") + ["é", "́",
                                                   "̈", "ि"]
           + ["🎉", "👍🏽", "‍", "️"]
           + list(" \t\n\r\x0b\x0c\x85\xa0     "
                  "   　\x1c\x1d\x1e\x1f\x00\x07\x7f"
                  "​᠎﻿"))
_ASSIGNED = st.characters(
    blacklist_categories=("Cs",), max_codepoint=0x10FFFF).filter(
    lambda c: unicodedata.category(c) != "Cn")


@settings(max_examples=400, deadline=None)
@given(st.lists(st.one_of(st.sampled_from(_PIECES), _ASSIGNED), max_size=40))
def test_gpt2_split_matches_regex(parts):
    text = "".join(parts)
    assert gpt2_split(text) == _GPT2.findall(text)


def test_gpt2_split_classes_match_regex_at_every_assigned_code_point():
    """Each assigned character alone, and a space and a letter around it:
    the scanner's letter, number and whitespace classes are regex's."""
    for c in range(0x110000):
        ch = chr(c)
        if unicodedata.category(ch) in ("Cn", "Cs"):
            continue
        text = f" {ch}a{ch}{ch} "
        assert gpt2_split(text) == _GPT2.findall(text), hex(c)


def test_builds_without_regex_jax_or_lamp_tpu(tmp_path):
    """The module imports and both families build and encode with
    ``regex``, ``jax``, ``lamp_tpu``, ``tokenizers`` and ``transformers``
    blocked."""
    for kind in ("byte_level", "metaspace"):
        _train(kind, str(tmp_path / f"{kind}.json"))
    code = f"""
import sys
for name in ("regex", "jax", "lamp_tpu", "tokenizers", "transformers"):
    sys.modules[name] = None
from lamp_tpu_torch.data.hf_tokenizer import HFTokenizer
for kind in ("byte_level", "metaspace"):
    t = HFTokenizer.from_file({str(tmp_path)!r} + "/" + kind + ".json")
    ids = t.encode("It's 東京 123  done")
    assert t.decode(ids) == "It's 東京 123  done", (kind, t.decode(ids))
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
