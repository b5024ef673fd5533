"""Constrained (grammar-guided) decoding for the serving engine.

Counterpart of :mod:`lamp_tpu.models.constrained`, copied whole: it is
numpy only, so the port keeps its own copy rather than import the JAX
package. A regular expression (or a bounded-depth JSON grammar) is compiled
into a DFA over BYTES and lifted to the model's TOKEN vocabulary; the
resulting transition table goes to the device once. Per decode step the
whole batch pays ONE gather:

    rows   = table[state]          # [B, V] int32: next state, or -1
    logits = where(rows >= 0, logits, -inf)
    token  ~ sample(logits)
    state  = rows[i, token]

so the mask and the state advance come from the same fetched rows, and the
constraint composes with temperature / top-k / top-p / penalties unchanged
(:meth:`lamp_tpu_torch.models.BatchServer.register_constraint`).

Pipeline: regex -> Thompson epsilon-NFA -> subset-construction DFA over
byte equivalence classes (the alphabet is compressed to the partition
induced by the NFA's edge sets, keeping subset construction cheap even for
the ~2^depth-state bounded JSON grammar) -> per-token byte walks produce
``table[n_states, vocab]``.

EOS handling: ``TokenDFA.compile(..., eos_token=t)`` permits ``t`` exactly
in ACCEPTING states (self-loop), so a constrained request can only
terminate once its output matches the full pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RegexError", "TokenDFA", "json_value_regex"]

DEAD = -1


class RegexError(ValueError):
    pass


# ---------------------------------------------------------------------------
# regex parsing — practical subset, byte semantics
# ---------------------------------------------------------------------------
#
# Supported: literals, '.', char classes [a-z0-9_] / [^...] (ranges,
# escapes), groups (...), alternation |, quantifiers * + ? {m} {m,} {m,n},
# escapes \d \D \w \W \s \S \n \r \t \\ \<punct>. Anchors are implicit:
# the pattern always describes the WHOLE emitted string (fullmatch), which
# is the only sensible semantics for generation.

_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F]
)
_SPACE = frozenset(b" \t\n\r\x0b\x0c")
_ALL = frozenset(range(256))


def _escape_set(c: str) -> FrozenSet[int]:
    if c == "d":
        return _DIGITS
    if c == "D":
        return _ALL - _DIGITS
    if c == "w":
        return _WORD
    if c == "W":
        return _ALL - _WORD
    if c == "s":
        return _SPACE
    if c == "S":
        return _ALL - _SPACE
    if c == "n":
        return frozenset((0x0A,))
    if c == "r":
        return frozenset((0x0D,))
    if c == "t":
        return frozenset((0x09,))
    if c == "0":
        return frozenset((0x00,))
    if c == "x":
        raise RegexError("\\xHH escapes: write the byte directly")
    # punctuation escape: \. \[ \( \\ etc. — the literal byte(s) of c
    return frozenset(c.encode("utf-8"))


# AST: ("lit", frozenset[int]) | ("cat", [..]) | ("alt", [..])
#    | ("star", node) | ("plus", node) | ("opt", node) | ("eps",)


class _Parser:
    def __init__(self, pattern: str):
        self.src = pattern
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.src[self.i] if self.i < len(self.src) else None

    def next(self) -> str:
        c = self.src[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self._alt()
        if self.i != len(self.src):
            raise RegexError(f"unexpected '{self.src[self.i]}' at {self.i}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self.peek() == "|":
            self.next()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        while True:
            c = self.peek()
            if c == "*":
                self.next()
                node = ("star", node)
            elif c == "+":
                self.next()
                node = ("plus", node)
            elif c == "?":
                self.next()
                node = ("opt", node)
            elif c == "{":
                node = self._braces(node)
            else:
                return node

    def _braces(self, node):
        j = self.src.find("}", self.i)
        if j < 0:
            raise RegexError("unterminated {")
        body = self.src[self.i + 1:j]
        self.i = j + 1
        if "," in body:
            lo_s, hi_s = body.split(",", 1)
            lo = int(lo_s) if lo_s else 0
            hi = int(hi_s) if hi_s else None
        else:
            lo = hi = int(body)
        if hi is not None and hi < lo:
            raise RegexError("{m,n} with n < m")
        parts: List = [node] * lo
        if hi is None:
            parts.append(("star", node))
        else:
            parts.extend([("opt", node)] * (hi - lo))
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _atom(self):
        c = self.next()
        if c == "(":
            node = self._alt()
            if self.peek() != ")":
                raise RegexError("unterminated (")
            self.next()
            return node
        if c == "[":
            return ("lit", self._char_class())
        if c == ".":
            return ("lit", _ALL - frozenset((0x0A,)))
        if c == "\\":
            if self.peek() is None:
                raise RegexError("trailing backslash")
            return ("lit", _escape_set(self.next()))
        if c in ")|*+?{":
            raise RegexError(f"unexpected '{c}'")
        return ("lit", frozenset(c.encode("utf-8")))

    def _char_class(self) -> FrozenSet[int]:
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        members: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexError("unterminated [")
            if c == "]" and not first:
                self.next()
                break
            first = False
            self.next()
            if c == "\\":
                members |= _escape_set(self.next())
                continue
            lo = c.encode("utf-8")
            if self.peek() == "-" and self.src[self.i + 1:self.i + 2] not in (
                    "]", ""):
                self.next()
                hi_c = self.next()
                if hi_c == "\\":
                    hi_c = self.next()
                hi = hi_c.encode("utf-8")
                if len(lo) != 1 or len(hi) != 1 or hi[0] < lo[0]:
                    raise RegexError("bad range in []")
                members |= set(range(lo[0], hi[0] + 1))
            else:
                members |= set(lo)
        return frozenset(_ALL - members if negate else members)


# ---------------------------------------------------------------------------
# Thompson NFA
# ---------------------------------------------------------------------------
# state = int; edges: eps[s] -> list of states, sym[s] -> (byteset, target)
# (each state has at most one symbol edge — Thompson construction invariant)


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.sym: List[Optional[Tuple[FrozenSet[int], int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.sym.append(None)
        return len(self.eps) - 1

    def build(self, node) -> Tuple[int, int]:
        """Returns (entry, exit)."""
        kind = node[0]
        if kind == "eps":
            s = self.state()
            return s, s
        if kind == "lit":
            a, b = self.state(), self.state()
            self.sym[a] = (node[1], b)
            return a, b
        if kind == "cat":
            first_in, prev_out = self.build(node[1][0])
            for sub in node[1][1:]:
                i, o = self.build(sub)
                self.eps[prev_out].append(i)
                prev_out = o
            return first_in, prev_out
        if kind == "alt":
            a, b = self.state(), self.state()
            for sub in node[1]:
                i, o = self.build(sub)
                self.eps[a].append(i)
                self.eps[o].append(b)
            return a, b
        if kind == "star":
            a, b = self.state(), self.state()
            i, o = self.build(node[1])
            self.eps[a] += [i, b]
            self.eps[o] += [i, b]
            return a, b
        if kind == "plus":
            i, o = self.build(node[1])
            b = self.state()
            self.eps[o] += [i, b]
            return i, b
        if kind == "opt":
            a, b = self.state(), self.state()
            i, o = self.build(node[1])
            self.eps[a] += [i, b]
            self.eps[o].append(b)
            return a, b
        raise AssertionError(kind)


def _eps_closure(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


def _byte_classes(nfa: _NFA) -> Tuple[np.ndarray, int]:
    """Partition bytes 0..255 into equivalence classes: two bytes are
    equivalent iff they belong to exactly the same set of NFA edges. Subset
    construction then runs over ~tens of classes instead of 256 bytes."""
    # signature per byte: bitmask over edge sets (dedup identical bytesets)
    sets: Dict[FrozenSet[int], int] = {}
    for edge in nfa.sym:
        if edge is not None and edge[0] not in sets:
            sets[edge[0]] = len(sets)
    sig = np.zeros(256, np.int64)
    for byteset, bit in sets.items():
        if bit < 63:
            mask = np.zeros(256, bool)
            mask[list(byteset)] = True
            sig[mask] |= 1 << bit
        else:  # rare: >63 distinct bytesets — fold via hashing
            for by in byteset:
                sig[by] = hash((sig[by], bit))
    uniq, cls = np.unique(sig, return_inverse=True)
    return cls.astype(np.int32), len(uniq)


def _nfa_to_dfa(nfa: _NFA, start: int, accept: int):
    """Subset construction. Returns (trans [S, 256] int32 with -1 dead,
    accepting bool [S], start_state)."""
    cls, n_cls = _byte_classes(nfa)
    # representative byte per class
    reps = [int(np.argmax(cls == c)) for c in range(n_cls)]

    start_set = _eps_closure(nfa, frozenset((start,)))
    index: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    trans_cls: List[List[int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = [DEAD] * n_cls
        edges = [nfa.sym[s] for s in cur if nfa.sym[s] is not None]
        for c in range(n_cls):
            rep = reps[c]
            tgt = frozenset(t for bs, t in edges if rep in bs)
            if tgt:
                closed = _eps_closure(nfa, tgt)
                j = index.get(closed)
                if j is None:
                    j = len(order)
                    index[closed] = j
                    order.append(closed)
                row[c] = j
            # else stays DEAD
        trans_cls.append(row)
        i += 1

    n = len(order)
    trans = np.asarray(trans_cls, np.int32)[:, cls]  # [S, 256]
    accepting = np.asarray([accept in st for st in order], bool)
    return trans, accepting


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenDFA:
    """A DFA lifted to the token vocabulary.

    table:      int32 [n_states, vocab] — next state, or -1 (forbidden).
    accepting:  bool  [n_states].
    start:      initial state index.
    """

    table: np.ndarray
    accepting: np.ndarray
    start: int

    @property
    def n_states(self) -> int:
        return self.table.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.table.shape[1]

    @staticmethod
    def compile(pattern: str, token_bytes: Sequence[bytes], *,
                eos_token: Optional[int] = None) -> "TokenDFA":
        """Compile ``pattern`` (regex subset, byte semantics, implicit
        fullmatch) against a vocabulary given as the byte string of every
        token. ``token_bytes[t]`` of length 0 (e.g. special tokens) is
        forbidden everywhere. ``eos_token`` (usually also empty) is instead
        allowed exactly in accepting states, as a self-loop — emitting it
        ends the request with a complete match.
        """
        ast = _Parser(pattern).parse()
        nfa = _NFA()
        entry, exit_ = nfa.build(ast)
        byte_trans, accepting = _nfa_to_dfa(nfa, entry, exit_)
        n_states = byte_trans.shape[0]
        vocab = len(token_bytes)

        table = np.full((n_states, vocab), DEAD, np.int32)
        # vectorized per-token walk: state vector over ALL dfa states
        # advances through the token's bytes simultaneously
        all_states = np.arange(n_states, dtype=np.int32)
        for t, bs in enumerate(token_bytes):
            if eos_token is not None and t == eos_token:
                continue
            if len(bs) == 0:
                continue
            cur = all_states
            for by in bs:
                safe = np.maximum(cur, 0)
                nxt = byte_trans[safe, by]
                cur = np.where(cur >= 0, nxt, DEAD)
            table[:, t] = cur
        if eos_token is not None:
            table[accepting, eos_token] = all_states[accepting]
        return TokenDFA(table=table, accepting=accepting, start=0)

    def match(self, tokens: Sequence[int]) -> bool:
        """Host-side check: does the token sequence reach an accepting
        state? (Used by tests and by engine-side stop handling.)"""
        s = self.start
        for t in tokens:
            s = int(self.table[s, t])
            if s == DEAD:
                return False
        return bool(self.accepting[s])


def byte_vocab(size: int = 256) -> List[bytes]:
    """token_bytes for a raw byte-level model: token i <-> byte i."""
    return [bytes([i]) for i in range(size)]


def json_value_regex(max_depth: int = 4, *, whitespace: str = " \\n\\t",
                     root: str = "value") -> str:
    """A regex for JSON with nesting bounded to ``max_depth`` (a DFA cannot
    count, so the depth bound is what makes JSON regular — the standard
    structured-output trick). ``root`` selects 'value' | 'object' | 'array'.
    NFA sharing keeps growth linear-per-level (one object + one array copy
    per level), so the subset construction stays small for typical depths.
    """
    ws = f"[{whitespace}]*"
    string = '"([^"\\\\\x00-\x1f]|\\\\(["\\\\/bfnrt]|u[0-9a-fA-F]{4}))*"'
    number = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?([eE][+-]?[0-9]+)?"
    scalar = f"({string}|{number}|true|false|null)"

    value = scalar
    for _ in range(max_depth):
        member = f"{string}{ws}:{ws}{value}"
        obj = f"\\{{{ws}({member}({ws},{ws}{member})*{ws})?\\}}"
        arr = f"\\[{ws}({value}({ws},{ws}{value})*{ws})?\\]"
        value = f"({scalar}|{obj}|{arr})"
    if root == "value":
        return value
    member = f"{string}{ws}:{ws}{value}"
    if root == "object":
        return f"\\{{{ws}({member}({ws},{ws}{member})*{ws})?\\}}"
    if root == "array":
        return f"\\[{ws}({value}({ws},{ws}{value})*{ws})?\\]"
    raise ValueError("root must be 'value', 'object' or 'array'")
