"""Invertible word-level tokenizer (a copy of ``sse_tpu/text/tokenizer.py``
for the PyTorch port).

Capability parity with the reference's ``tokenizer.py`` (SURVEY.md §2.1:
"invertible word/punctuation tokenizer ... splits on unicode category
boundaries, preserves exact round-trip"). Clean-room implementation of the
published tensor2tensor algorithm:

* A string is split into maximal runs of *alphanumeric* characters and runs
  of *non-alphanumeric* characters (unicode categories ``L*`` / ``N*`` decide
  alphanumeric).
* A single ``" "`` separating two alphanumeric runs is dropped during
  tokenization and re-inserted during detokenization, so ordinary prose
  round-trips without littering the token stream with space tokens.

``detokenize(tokenize(s)) == s`` for every unicode string ``s``.
"""

from __future__ import annotations

import sys
import unicodedata
from typing import List

# Unicode categories whose characters count as "alphanumeric" for run
# splitting: letters (Lu Ll Lt Lm Lo) and numbers (Nd Nl No).
_ALNUM_PREFIXES = ("L", "N")


def _build_alnum_table() -> frozenset:
    return frozenset(
        chr(cp)
        for cp in range(sys.maxunicode + 1)
        if unicodedata.category(chr(cp)).startswith(_ALNUM_PREFIXES)
    )


_ALNUM: frozenset = _build_alnum_table()


def is_alnum(ch: str) -> bool:
    """True if `ch` belongs to a unicode letter or number category."""
    return ch in _ALNUM


def tokenize(text: str) -> List[str]:
    """Split `text` into an invertible token list.

    Tokens are maximal same-class (alnum vs non-alnum) runs; a lone space
    between two alnum runs is dropped (recovered by :func:`detokenize`).
    """
    if not text:
        return []
    tokens: List[str] = []
    start = 0
    prev_alnum = is_alnum(text[0])
    for pos in range(1, len(text)):
        cur_alnum = is_alnum(text[pos])
        if cur_alnum != prev_alnum:
            run = text[start:pos]
            # Drop a single separating space unless it leads the string.
            if run != " " or start == 0:
                tokens.append(run)
            start = pos
            prev_alnum = cur_alnum
    tokens.append(text[start:])
    return tokens


def detokenize(tokens: List[str]) -> str:
    """Exact inverse of :func:`tokenize`."""
    out: List[str] = []
    prev_was_alnum = False
    for i, tok in enumerate(tokens):
        cur_is_alnum = bool(tok) and is_alnum(tok[0])
        if i > 0 and prev_was_alnum and cur_is_alnum:
            out.append(" ")
        out.append(tok)
        prev_was_alnum = cur_is_alnum
    return "".join(out)
