"""Data utilities. Counterpart of :mod:`lamp_tpu.data`: batch streams and
the prefetch to the card, the tokenizer and codecs, and the language-model
data (corpus minibatches, packed documents, sampling inference), and the
HuggingFace ``tokenizer.json`` BPE codec. The text, BERT, graph, image
and reader modules are not ported yet."""

from .batchstream import (
    BatchStream,
    from_full_batch,
    from_function,
    from_indices,
    minibatches_from_full,
    prefetch_to_device,
    staged_from_indices,
)
from .hf_tokenizer import HFTokenizer
from .lm_data import (
    autoregressive_inference,
    autoregressive_minibatches_from_corpus,
    pack_documents,
)
from .tokenizer import (
    ByteSegmentCodec,
    Codec,
    IdentityCodec,
    bpe_decode,
    bpe_encode,
    train_bpe,
)

__all__ = [
    "BatchStream",
    "from_full_batch",
    "from_function",
    "from_indices",
    "minibatches_from_full",
    "prefetch_to_device",
    "staged_from_indices",
    "HFTokenizer",
    "train_bpe",
    "bpe_encode",
    "bpe_decode",
    "ByteSegmentCodec",
    "IdentityCodec",
    "Codec",
    "autoregressive_minibatches_from_corpus",
    "autoregressive_inference",
    "pack_documents",
]
