"""Clean-room subword vocabulary (BPE-style, tensor2tensor algorithm family).

Capability parity with the reference's ``text_encoder.py``
(SURVEY.md §2.1: "BPE-like SubwordTextEncoder: builds subword vocab of a
requested size from token counts (iterative binary search on min_count),
encodes token strings → subword id lists ... reserved ids PAD=0, EOS=1").
A copy of ``sse_tpu/text/subword.py`` for the PyTorch port: the same
algorithm (Vaswani et al. 2017 appendix; tensor2tensor docs) and the same
vocab file format, so a vocab saved by either package loads in the other.

Key invariants (tested in tests/test_text.py and tests/test_torch_data.py):
  * ``decode(encode(s)) == s`` for any unicode string (full invertibility
    via escaping + the invertible tokenizer).
  * Deterministic: same token counts + target size → same vocab, any platform.
  * Greedy longest-match segmentation always succeeds (every alphabet
    character is itself a subword, and escaping confines tokens to the
    alphabet).
"""

from __future__ import annotations

import collections
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from sse_tpu_torch.text import tokenizer

PAD = "<pad>"
EOS = "<EOS>"
RESERVED_TOKENS: Tuple[str, str] = (PAD, EOS)
PAD_ID = 0
EOS_ID = 1

# Characters that escaping may introduce; always forced into the alphabet so
# that segmentation of escaped tokens can never fail.
_ESCAPE_CHARS = frozenset("\\_u;0123456789")
# Marker appended to every escaped token; doubles as the token boundary when
# decoding a concatenated subword stream ("_" inside tokens becomes "\\u").
_END = "_"


def _escape_token(token: str, alphabet: frozenset) -> str:
    r"""Escape `token` so it consists only of alphabet chars and ends in "_".

    "\\" -> "\\\\",  "_" -> "\\u",  any char outside `alphabet` (or "\n")
    -> "\\<codepoint>;".
    """
    out = []
    for ch in token:
        if ch == "\\":
            out.append("\\\\")
        elif ch == _END:
            out.append("\\u")
        elif ch in alphabet and ch != "\n":
            out.append(ch)
        else:
            out.append("\\%d;" % ord(ch))
    out.append(_END)
    return "".join(out)


def _unescape_token(escaped: str) -> str:
    """Inverse of :func:`_escape_token` (input may include the trailing _)."""
    if escaped.endswith(_END):
        escaped = escaped[:-1]
    out = []
    pos = 0
    n = len(escaped)
    while pos < n:
        ch = escaped[pos]
        if ch != "\\":
            out.append(ch)
            pos += 1
            continue
        if pos + 1 >= n:  # dangling backslash: tolerate, emit literally
            out.append(ch)
            break
        nxt = escaped[pos + 1]
        if nxt == "u":
            out.append(_END)
            pos += 2
        elif nxt == "\\":
            out.append("\\")
            pos += 2
        else:  # \<digits>;
            end = escaped.find(";", pos + 1)
            if end == -1:
                out.append(ch)
                pos += 1
            else:
                try:
                    out.append(chr(int(escaped[pos + 1 : end])))
                except ValueError:
                    out.append(escaped[pos:end])
                pos = end + 1
    return "".join(out)


class SubwordVocab:
    """Subword vocabulary with greedy longest-match segmentation.

    ids: 0 = PAD, 1 = EOS, 2.. = subword strings over escaped tokens.
    """

    def __init__(self, subtokens: Sequence[str]):
        # `subtokens` excludes reserved tokens.
        self._subtokens: List[str] = list(RESERVED_TOKENS) + list(subtokens)
        self._ids: Dict[str, int] = {s: i for i, s in enumerate(self._subtokens)}
        if len(self._ids) != len(self._subtokens):
            raise ValueError("duplicate subtokens in vocabulary")
        self._max_len = max((len(s) for s in subtokens), default=1)
        self._alphabet = frozenset(
            ch for s in subtokens if len(s) == 1 for ch in s
        )

    # ------------------------------------------------------------------ api
    @property
    def vocab_size(self) -> int:
        return len(self._subtokens)

    @property
    def alphabet(self) -> frozenset:
        return self._alphabet

    def subtoken_to_id(self, subtoken: str) -> int:
        return self._ids[subtoken]

    def id_to_subtoken(self, idx: int) -> str:
        return self._subtokens[idx]

    def encode(self, text: str) -> List[int]:
        """Text → subword ids (no EOS appended; the data layer owns that)."""
        ids: List[int] = []
        for token in tokenizer.tokenize(text):
            ids.extend(self._encode_escaped(_escape_token(token, self._alphabet)))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        """Subword ids → text. Exact inverse of :meth:`encode`."""
        concat = "".join(
            self._subtokens[i]
            for i in ids
            if i >= len(RESERVED_TOKENS)
        )
        tokens: List[str] = []
        start = 0
        for pos, ch in enumerate(concat):
            if ch == _END:  # unescaped "_" only ever appears as terminator
                tokens.append(_unescape_token(concat[start : pos + 1]))
                start = pos + 1
        return tokenizer.detokenize(tokens)

    def _encode_escaped(self, escaped: str) -> List[int]:
        """Greedy longest-match segmentation of one escaped token."""
        ids: List[int] = []
        start = 0
        n = len(escaped)
        while start < n:
            for end in range(min(n, start + self._max_len), start, -1):
                sub = escaped[start:end]
                sid = self._ids.get(sub)
                if sid is not None:
                    ids.append(sid)
                    start = end
                    break
            else:
                # Char outside alphabet (can't happen after escaping with our
                # own alphabet, but be robust to foreign vocab files): skip.
                start += 1
        return ids

    def content_digest(self) -> str:
        """Stable hash of the full subtoken list. Cache keys must use this
        (not vocab_size): two vocabs of the same size with different
        subtokens produce different encodings."""
        import hashlib

        h = hashlib.sha256()
        for s in self._subtokens:
            h.update(s.encode("utf-8"))
            h.update(b"\x00")
        return h.hexdigest()[:16]

    # ------------------------------------------------------------- persist
    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for s in self._subtokens[len(RESERVED_TOKENS) :]:
                f.write(json.dumps(s, ensure_ascii=False) + "\n")

    @classmethod
    def load(cls, path: str) -> "SubwordVocab":
        subs = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    subs.append(json.loads(line))
        return cls(subs)

    # ------------------------------------------------------------ construction
    @classmethod
    def build_from_token_counts(
        cls,
        token_counts: Dict[str, int],
        min_count: int,
        num_iterations: int = 4,
        max_subtoken_length: Optional[int] = None,
        use_native: bool = True,
    ) -> "SubwordVocab":
        """EM-style construction: segment with current vocab, count candidate
        substrings, keep those with count >= min_count (longest first,
        subtracting prefix counts), repeat.

        The candidate loop is O(len²) per token, so by default the port's
        C++ copy of this build runs (``sse_tpu_torch.native``, multithreaded;
        a failed library build raises). ``use_native=False`` runs this
        pure-Python body, the plain version: the same algorithm, the same
        vocab bit for bit (tests/test_torch_native.py)."""
        if use_native:
            from sse_tpu_torch.native import native_build_subtokens

            return cls(native_build_subtokens(
                token_counts, min_count, num_iterations, max_subtoken_length
            ))
        alphabet = frozenset(
            ch for tok in token_counts for ch in tok
        ) | _ESCAPE_CHARS
        escaped_counts = {
            _escape_token(tok, alphabet): cnt for tok, cnt in token_counts.items()
        }
        # Iteration 0 segments by single characters.
        vocab = cls(sorted(alphabet))
        for _ in range(num_iterations):
            cand_counts: Dict[str, int] = collections.defaultdict(int)
            for escaped, count in escaped_counts.items():
                start = 0
                # Segment with the current vocab; every candidate substring
                # starting at a segmentation boundary accumulates count.
                for sid in vocab._encode_escaped(escaped):
                    sub_len = len(vocab._subtokens[sid])
                    limit = len(escaped)
                    # 0/None both mean UNBOUNDED, as in the JAX package's
                    # C++ vocab build (0 is its "no limit"), so that both build
                    # the same vocab for --max_subtoken_length 0
                    if max_subtoken_length:
                        limit = min(limit, start + max_subtoken_length)
                    for end in range(start + 1, limit + 1):
                        cand_counts[escaped[start:end]] += count
                    start += sub_len
            # Bucket candidates by length; take longest-first, subtracting
            # the winner's count from all of its prefixes so shorter
            # substrings only survive on their *independent* usefulness.
            by_len: Dict[int, List[str]] = collections.defaultdict(list)
            for sub, cnt in cand_counts.items():
                if cnt >= min_count:
                    by_len[len(sub)].append(sub)
            new_subtokens: List[Tuple[int, str]] = []
            for length in sorted(by_len, reverse=True):
                for sub in by_len[length]:
                    cnt = cand_counts[sub]
                    if cnt < min_count:
                        continue
                    if length > 1:  # alphabet chars are added unconditionally
                        new_subtokens.append((cnt, sub))
                    for l in range(1, length):
                        cand_counts[sub[:l]] -= cnt
            # Alphabet always present so segmentation cannot fail.
            new_subtokens.extend(
                (cand_counts.get(ch, 0), ch) for ch in alphabet
            )
            # Deterministic order: count desc, then lexicographic.
            new_subtokens.sort(key=lambda cs: (-cs[0], cs[1]))
            vocab = cls([s for _, s in new_subtokens])
        return vocab

    @classmethod
    def build_to_target_size(
        cls,
        target_size: int,
        token_counts: Dict[str, int],
        min_val: int = 1,
        max_val: int = 1000,
        num_iterations: int = 4,
        max_subtoken_length: Optional[int] = None,
    ) -> "SubwordVocab":
        """Binary-search `min_count` in [min_val, max_val] for a vocab whose
        size is closest to (and the search biases toward >=) `target_size`."""
        if target_size < len(RESERVED_TOKENS) + 1:
            raise ValueError("target_size too small")

        best: Optional[SubwordVocab] = None

        def bisect(lo: int, hi: int) -> None:
            nonlocal best
            mid = (lo + hi) // 2
            vocab = cls.build_from_token_counts(
                token_counts, mid, num_iterations, max_subtoken_length
            )
            if best is None or abs(vocab.vocab_size - target_size) < abs(
                best.vocab_size - target_size
            ):
                best = vocab
            if lo >= hi:
                return
            if vocab.vocab_size > target_size:
                bisect(mid + 1, hi)
            elif mid > lo:
                bisect(lo, mid - 1)

        bisect(min_val, max_val)
        assert best is not None
        return best


class TokenVocab:
    """Plain word-level vocabulary with OOV (the reference's
    ``TokenTextEncoder`` analog; SURVEY.md §2.1)."""

    OOV = "<UNK>"

    def __init__(self, tokens: Sequence[str]):
        self._tokens = list(RESERVED_TOKENS) + [self.OOV] + list(tokens)
        self._ids = {t: i for i, t in enumerate(self._tokens)}
        self._oov_id = self._ids[self.OOV]

    @property
    def vocab_size(self) -> int:
        return len(self._tokens)

    def encode(self, text: str) -> List[int]:
        return [
            self._ids.get(tok, self._oov_id) for tok in tokenizer.tokenize(text)
        ]

    def decode(self, ids: Iterable[int]) -> str:
        return tokenizer.detokenize(
            [self._tokens[i] for i in ids if i >= len(RESERVED_TOKENS)]
        )

    def content_digest(self) -> str:
        import hashlib

        h = hashlib.sha256(b"token-vocab\x00")
        for t in self._tokens:
            h.update(t.encode("utf-8"))
            h.update(b"\x00")
        return h.hexdigest()[:16]

    # Same persist format as SubwordVocab (JSON string per line) with a
    # marker first line so loaders can dispatch on vocab mode.
    MARKER = '"<token-vocab>"'

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.MARKER + "\n")
            for t in self._tokens[len(RESERVED_TOKENS) + 1 :]:  # skip OOV
                f.write(json.dumps(t, ensure_ascii=False) + "\n")

    @classmethod
    def load(cls, path: str) -> "TokenVocab":
        toks = []
        with open(path, "r", encoding="utf-8") as f:
            first = f.readline().rstrip("\n")
            if first != cls.MARKER:
                raise ValueError(f"{path} is not a token vocab")
            for line in f:
                line = line.rstrip("\n")
                if line:
                    toks.append(json.loads(line))
        return cls(toks)

    @classmethod
    def build(cls, token_counts: Dict[str, int], vocab_size: int) -> "TokenVocab":
        """Top-(vocab_size - 3) tokens by count (ties: lexicographic) —
        the reference's word-level TokenTextEncoder path (SURVEY.md §2.1),
        with OOV for everything else."""
        keep = max(vocab_size - len(RESERVED_TOKENS) - 1, 1)
        ordered = sorted(token_counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return cls([t for t, _ in ordered[:keep]])


def load_vocab(path: str):
    """Dispatch on the saved vocab's mode marker."""
    with open(path, "r", encoding="utf-8") as f:
        first = f.readline().rstrip("\n")
    if first == TokenVocab.MARKER:
        return TokenVocab.load(path)
    return SubwordVocab.load(path)


def token_counts_from_lines(lines: Iterable[str]) -> Dict[str, int]:
    """Corpus lines → token count dict (the input of a vocab build)."""
    counts: Dict[str, int] = collections.defaultdict(int)
    for line in lines:
        for tok in tokenizer.tokenize(line):
            counts[tok] += 1
    return dict(counts)
