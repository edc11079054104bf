"""Text layer of the port: invertible tokenization and subword vocabularies
(a copy of ``sse_tpu.text``; pure Python, no JAX)."""

from sse_tpu_torch.text.subword import EOS_ID, PAD_ID, RESERVED_TOKENS, SubwordVocab
from sse_tpu_torch.text.tokenizer import detokenize, tokenize

__all__ = [
    "tokenize",
    "detokenize",
    "SubwordVocab",
    "PAD_ID",
    "EOS_ID",
    "RESERVED_TOKENS",
]
