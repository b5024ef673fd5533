"""HuggingFace ``tokenizer.json`` interop: a self-contained BPE codec.

Counterpart of :mod:`lamp_tpu.data.hf_tokenizer` (a copy), for the two
dominant families of BPE vocabularies:

- **byte-level BPE** (GPT-2/RoBERTa/GPT-NeoX): ByteLevel pre-tokenizer with
  the GPT-2 split, bytes mapped through the GPT-2 byte<->unicode table,
  rank-greedy pair merging.
- **Metaspace BPE** (Llama-1/2, Mistral sentencepiece exports): whitespace
  replaced by U+2581, optional prefix space, byte fallback tokens
  ``<0xNN>``.

The one change: the JAX module splits byte-level text with the ``regex``
package's pattern::

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

and the card's machine has no ``regex`` package. :func:`gpt2_split` is a
hand-written scanner with the same alternation, tried in the same order at
each position: letters are the characters whose ``unicodedata`` category
is ``L*``, numbers ``N*``, and whitespace the Unicode White_Space set
(``regex``'s ``\\s``; it is not ``str.isspace()``, which also takes
U+001C-U+001F). ``unicodedata`` carries the Unicode version of the Python
build (15.0.0 in Python 3.12), where a recent ``regex`` release carries a
later one (16.0 or 17.0): the two differ only at code points unassigned in
Unicode 15.0 (``Cn`` here), which the new versions made letters or digits.
The scanner is built only for byte-level tokenizers; a Metaspace tokenizer
never splits.
"""

from __future__ import annotations

import functools
import json
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["HFTokenizer", "gpt2_split"]

_METASPACE = "▁"


def _gpt2_byte_encoder() -> Dict[int, str]:
    """The GPT-2 byte -> unicode printable-char table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENC = _gpt2_byte_encoder()
_BYTE_DEC = {c: b for b, c in _BYTE_ENC.items()}

# Unicode's White_Space property (the regex package's \s)
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004"
    "\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f"
    "\u3000")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# character classes of the split: letter, number, whitespace, other
_LETTER, _NUMBER, _SPACE, _OTHER = range(4)


@functools.lru_cache(maxsize=65536)
def _char_class(ch: str) -> int:
    if ch in _WHITESPACE:
        return _SPACE
    cat = unicodedata.category(ch)
    if cat[0] == "L":
        return _LETTER
    if cat[0] == "N":
        return _NUMBER
    return _OTHER


def gpt2_split(text: str) -> List[str]:
    """The pieces that ``regex.findall`` of GPT-2's pre-tokenization
    pattern gives (contractions, ` ?letters`, ` ?numbers`, ` ?other`,
    whitespace not followed by a non-space, whitespace), by a scanner that
    tries the alternatives in the pattern's order at each position."""
    cls = [_char_class(c) for c in text]
    n = len(text)
    out = []
    i = 0
    while i < n:
        if text[i] == "'":
            hit = next((s for s in _CONTRACTIONS
                        if text.startswith(s, i + 1)), None)
            if hit is not None:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        # ` ?X+` for letters, numbers, then other: an optional U+0020, then
        # a run of the class of the character after it
        j = i + 1 if text[i] == " " and i + 1 < n else i
        run = cls[j]
        if run != _SPACE:
            k = j + 1
            while k < n and cls[k] == run:
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # whitespace: the maximal run, less its last character when a
        # non-space follows (\s+(?!\S)), else the whole run (\s+)
        k = i + 1
        while k < n and cls[k] == _SPACE:
            k += 1
        if k < n and k - i > 1:
            k -= 1
        out.append(text[i:k])
        i = k
    return out


class HFTokenizer:
    """Parses a HF ``tokenizer.json`` (BPE models) and provides
    ``encode`` / ``decode`` / ``token_bytes``.

    Special/added tokens are matched verbatim before pre-tokenization (the
    HF "added vocabulary" behavior). Unknown characters fall back to the
    model's ``unk_token`` (or byte-fallback tokens when present).
    """

    def __init__(self, spec: dict):
        model = spec.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(
                f"only BPE tokenizer.json supported, got {model.get('type')}"
            )
        self.vocab: Dict[str, int] = dict(model["vocab"])
        merges = model.get("merges", [])
        self.ranks: Dict[Tuple[str, str], int] = {}
        for i, m in enumerate(merges):
            pair = tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            self.ranks[pair] = i
        self.unk_token: Optional[str] = model.get("unk_token")
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))

        self.added: Dict[str, int] = {}
        self.special: set = set()
        for tok in spec.get("added_tokens", []) or []:
            self.added[tok["content"]] = tok["id"]
            if tok.get("special"):
                self.special.add(tok["content"])
            self.vocab.setdefault(tok["content"], tok["id"])

        self.id_to_token: Dict[int, str] = {}
        for t, i in self.vocab.items():
            self.id_to_token[i] = t

        # pre-tokenizer / decoder family detection
        self.mode = "none"
        self.add_prefix_space = False
        self.metaspace_prepend = True
        for pt in self._flatten(spec.get("pre_tokenizer")):
            t = pt.get("type")
            if t == "ByteLevel":
                self.mode = "byte_level"
                self.add_prefix_space = bool(pt.get("add_prefix_space",
                                                    False))
            elif t == "Metaspace":
                self.mode = "metaspace"
                scheme = pt.get("prepend_scheme",
                                "always" if pt.get("add_prefix_space", True)
                                else "never")
                self.metaspace_prepend = scheme != "never"
        if self.mode == "none":
            for dc in self._flatten(spec.get("decoder")):
                if dc.get("type") == "ByteLevel":
                    self.mode = "byte_level"
                elif dc.get("type") == "Metaspace":
                    self.mode = "metaspace"

    @staticmethod
    def _flatten(node) -> List[dict]:
        if not node:
            return []
        if node.get("type") == "Sequence":
            out = []
            for sub in (node.get("pretokenizers")
                        or node.get("decoders") or []):
                out.extend(HFTokenizer._flatten(sub))
            return out
        return [node]

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f))

    # -- encoding -----------------------------------------------------------

    def _bpe(self, symbols: List[str]) -> List[str]:
        """Rank-greedy merge loop (the BPE algorithm)."""
        if len(symbols) < 2:
            return symbols
        while True:
            best_rank = None
            best_i = -1
            for i in range(len(symbols) - 1):
                r = self.ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                return symbols
            symbols = (symbols[:best_i]
                       + [symbols[best_i] + symbols[best_i + 1]]
                       + symbols[best_i + 2:])

    def _word_ids(self, word: str) -> List[int]:
        toks = self._bpe(list(word))
        out: List[int] = []
        for t in toks:
            i = self.vocab.get(t)
            if i is not None:
                out.append(i)
                continue
            # unmergeable symbol: byte fallback, then unk
            handled = False
            if self.byte_fallback:
                bts = t.encode("utf-8")
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in bts]
                if all(j is not None for j in ids):
                    out.extend(ids)
                    handled = True
            if not handled and self.unk_token is not None:
                u = self.vocab[self.unk_token]
                if not (self.fuse_unk and out and out[-1] == u):
                    out.append(u)
        return out

    def encode(self, text: str) -> List[int]:
        # split out added/special tokens first (verbatim match)
        segments: List[Tuple[str, bool]] = [(text, False)]
        for tok in sorted(self.added, key=len, reverse=True):
            nxt: List[Tuple[str, bool]] = []
            for seg, is_tok in segments:
                if is_tok:
                    nxt.append((seg, True))
                    continue
                parts = seg.split(tok)
                for j, p in enumerate(parts):
                    if j:
                        nxt.append((tok, True))
                    if p:
                        nxt.append((p, False))
            segments = nxt

        ids: List[int] = []
        for seg, is_tok in segments:
            if is_tok:
                ids.append(self.added[seg])
            elif self.mode == "byte_level":
                s = " " + seg if self.add_prefix_space else seg
                for m in gpt2_split(s):
                    word = "".join(_BYTE_ENC[b] for b in m.encode("utf-8"))
                    ids.extend(self._word_ids(word))
            elif self.mode == "metaspace":
                s = seg.replace(" ", _METASPACE)
                if self.metaspace_prepend and not s.startswith(_METASPACE):
                    s = _METASPACE + s
                ids.extend(self._word_ids(s))
            else:
                ids.extend(self._word_ids(seg))
        return ids

    # -- decoding -----------------------------------------------------------

    def _token_raw_bytes(self, tok: str) -> bytes:
        """The byte contribution of one (non-added) token: byte-level map,
        byte-fallback <0xNN>, or the utf-8 of the metaspace-restored text.
        Assembling BYTES (not str) lets multi-token utf-8 sequences from
        byte-fallback reassemble correctly."""
        if self.mode == "byte_level":
            return bytes(_BYTE_DEC.get(c, ord(" ")) for c in tok)
        if self.byte_fallback and len(tok) == 6 and tok.startswith("<0x") \
                and tok.endswith(">"):
            return bytes([int(tok[3:5], 16)])
        return tok.replace(_METASPACE, " ").encode("utf-8")

    def decode(self, ids: Sequence[int], *,
               skip_special_tokens: bool = True) -> str:
        out = bytearray()
        added_ids = set(self.added.values())
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                continue
            if skip_special_tokens and tok in self.special:
                continue
            if int(i) in added_ids and tok not in self.special:
                out += tok.encode("utf-8")
            else:
                out += self._token_raw_bytes(tok)
        text = out.decode("utf-8", errors="replace")
        if self.mode == "metaspace" and self.metaspace_prepend \
                and text.startswith(" "):
            text = text[1:]
        return text

    # -- constrained-decoding bridge ---------------------------------------

    def token_bytes(self) -> List[bytes]:
        """Byte string of every vocab id, for
        :meth:`lamp_tpu_torch.models.constrained.TokenDFA.compile`. Special/added
        tokens map to b'' (forbidden inside a constrained region — pass the
        EOS id via ``eos_token`` instead)."""
        n = max(self.id_to_token) + 1
        out = [b""] * n
        for i, tok in self.id_to_token.items():
            if tok in self.special:
                continue
            out[i] = self._token_raw_bytes(tok)
        return out

    @property
    def vocab_size(self) -> int:
        return max(self.id_to_token) + 1
