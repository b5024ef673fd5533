"""Port parity: lamp_tpu_torch.data.pack_documents against
lamp_tpu.data.pack_documents, array for array (both are numpy: equal
exactly)."""

import numpy as np
import pytest

from lamp_tpu.data import pack_documents as jax_pack
from lamp_tpu_torch.data import pack_documents


def _docs(seed, n, lo, hi, vocab=50):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, rng.randint(lo, hi + 1)).astype(np.int32)
            for _ in range(n)]


# (name, documents, context length, keyword arguments)
CASES = [
    ("short_docs", _docs(0, 12, 1, 9), 16, {}),
    ("long_docs_truncated", _docs(1, 6, 10, 40), 24, {}),
    ("first_fit_gaps", [np.arange(1, 11), np.arange(1, 8), np.arange(1, 4),
                        np.arange(1, 6), np.arange(1, 2)], 12, {}),
    ("empty_doc_skipped", [np.arange(1, 5), np.array([], np.int32),
                           np.arange(1, 3)], 8, {}),
    ("pad_and_ignore", _docs(2, 9, 3, 20), 32,
     dict(pad_id=7, ignore_index=-1)),
    ("packed_training_shape", _docs(3, 32, 64, 1024, vocab=32000), 2048, {}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pack_documents_matches_jax(case):
    _, docs, ctx, kw = case
    want = jax_pack(docs, ctx, **kw)
    got = pack_documents(docs, ctx, **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.int32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_pack_documents_rows_hold_whole_documents():
    docs = _docs(4, 20, 2, 15)
    p = pack_documents(docs, 16)
    # every non-pad token belongs to one document, targets stay inside it
    # and positions restart at each document
    for r in range(p["tokens"].shape[0]):
        seg, pos, tgt = p["segment_ids"][r], p["positions"][r], \
            p["targets"][r]
        starts = np.flatnonzero(pos == 0)
        assert starts[0] == 0
        for a, b in zip(starts, list(starts[1:]) + [16]):
            assert (seg[a:b] == seg[a]).all()
            assert tgt[b - 1] == -100
