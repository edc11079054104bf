"""Synthetic corpora with reference-schema files (a copy of
``sse_tpu/data/synthetic.py`` for the PyTorch port: same rows for the
same seed).

SURVEY.md §6 risk note: the reference's demo datasets were downloaded from
eBay hosting and are unavailable here (empty mount, no egress). This module
implements the documented fallback: synthetic corpora with the exact
TrainPairs / EvalPairs / targetIDs schema and enough learnable structure
that recall@k provably improves over random — one generator per task mode.

Structure: each target owns a pool of characteristic words; a source is a
bag of words sampled mostly from its target's pool plus noise. Cross-lingual
sources are drawn from a disjoint "source-language" word list related to the
target words by a fixed bijection, so only a model that learns the mapping
(not string overlap) scores well. QnA targets are longer passages.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Sequence, Tuple

_CONSONANTS = "bcdfghjklmnpqrstvwz"
_VOWELS = "aeiou"


def _word(rng: random.Random, syllables: int = 2) -> str:
    return "".join(
        rng.choice(_CONSONANTS) + rng.choice(_VOWELS)
        for _ in range(syllables)
    )


def _word_bank(rng: random.Random, n: int, syllables: int = 2) -> List[str]:
    bank: List[str] = []
    seen = set()
    while len(bank) < n:
        w = _word(rng, syllables)
        if w not in seen:
            seen.add(w)
            bank.append(w)
    return bank


def make_corpus(
    task: str = "classification",
    num_targets: int = 32,
    train_per_target: int = 20,
    eval_per_target: int = 4,
    words_per_target: int = 6,
    src_words: int = 5,
    noise_words: int = 1,
    seed: int = 0,
) -> Tuple[List[Tuple[str, List[str]]], List[Tuple[str, List[str]]], List[Tuple[str, str]]]:
    """Return (train_pairs, eval_pairs, target_rows) in the reference's
    row shapes (see corpus.read_pairs_tsv / read_targets_tsv)."""
    if task not in ("classification", "ranking", "crosslingual", "qna"):
        raise ValueError(f"unknown task {task!r}")
    rng = random.Random(seed)
    tgt_bank = _word_bank(rng, num_targets * words_per_target)
    noise_bank = _word_bank(rng, 50, syllables=3)
    # Cross-lingual: sources use a disjoint language; bijective word map.
    if task == "crosslingual":
        src_bank = _word_bank(rng, len(tgt_bank), syllables=4)
        translate: Dict[str, str] = dict(zip(tgt_bank, src_bank))
    else:
        translate = {w: w for w in tgt_bank}

    pools = [
        tgt_bank[i * words_per_target : (i + 1) * words_per_target]
        for i in range(num_targets)
    ]
    target_rows: List[Tuple[str, str]] = []
    for i, pool in enumerate(pools):
        if task == "qna":  # longer answer passages
            text = " ".join(pool + rng.sample(noise_bank, 3))
        elif task == "classification":  # category-name-like targets
            text = " ".join(pool[:3])
        else:  # ranking / crosslingual: listing-title-like targets
            text = " ".join(pool)
        target_rows.append((f"t{i:05d}", text))

    def sample_pairs(count_per_target: int, rng: random.Random):
        pairs = []
        for i, pool in enumerate(pools):
            for _ in range(count_per_target):
                words = [
                    translate[w]
                    for w in rng.choices(pool, k=src_words)
                ] + rng.sample(noise_bank, noise_words)
                rng.shuffle(words)
                pairs.append((" ".join(words), [f"t{i:05d}"]))
        rng.shuffle(pairs)
        return pairs

    train_pairs = sample_pairs(train_per_target, random.Random(seed + 1))
    eval_pairs = sample_pairs(eval_per_target, random.Random(seed + 2))
    return train_pairs, eval_pairs, target_rows


def make_hard_corpus(
    task: str = "classification",
    num_targets: int = 2048,
    cluster_size: int = 16,
    train_per_target: int = 8,
    eval_per_target: int = 2,
    core_words: int = 6,
    distinct_words: int = 3,
    src_words: int = 6,
    p_distinct: float = 0.3,
    noise_words: int = 2,
    multi_label_frac: float = 0.15,
    train_multi_label_frac: float = 0.0,
    seed: int = 0,
) -> Tuple[List[Tuple[str, List[str]]], List[Tuple[str, List[str]]], List[Tuple[str, str]]]:
    """The DISCRIMINATIVE benchmark profile (round-2 instrument).

    The easy profile (make_corpus: disjoint word pools, 1 noise word)
    saturates every stock preset at recall 1.000, which verifies nothing.
    This profile is tuned so good models land recall@1 ≈ 0.6–0.9 and
    quality differences (margin, bidirectional, tower choice) are visible:

      * **confusable clusters** — targets come in clusters of
        ``cluster_size`` sharing a core word pool; only ``distinct_words``
        per-target words separate siblings. A source word is distinctive
        with probability ``p_distinct``; a source that happens to draw
        zero distinctive words is IRREDUCIBLY ambiguous within its
        cluster, so no model can hit 1.000. The recall@1 ceiling at the
        defaults is **0.7795**, MEASURED by a Bayes-optimal scorer with
        full generator knowledge (r3; BASELINE.md) — the naive formula
        1-(1-p_distinct)^src_words + rest/cluster_size ≈ 0.89 overcounts
        because it ignores noise-word and Zipf-core collisions. The
        greedy word-overlap oracle also achieves exactly 0.7795: word
        identity carries ALL the label signal this generator emits, so
        in-vocabulary tasks measure how close a model gets to the
        lexical ceiling, while crosslingual (disjoint vocabularies)
        measures pure learned mapping.
      * **Zipfian word frequencies** inside core pools and the noise bank
        (weight ∝ 1/rank), so frequent words are weak evidence.
      * **more noise** — ``noise_words`` per source from a 400-word bank.
      * **multi-label eval rows** — a ``multi_label_frac`` fraction of
        eval sources use only cluster-core words and carry BOTH the
        target and a sibling as correct labels (the reference's
        multi-id TSV convention; recall counts ANY hit).

    Same return shape as make_corpus.
    """
    if task not in ("classification", "ranking", "crosslingual", "qna"):
        raise ValueError(f"unknown task {task!r}")
    if num_targets % cluster_size:
        raise ValueError("num_targets must be a multiple of cluster_size")
    rng = random.Random(seed)
    n_clusters = num_targets // cluster_size
    # distinct banks can't collide: word LENGTH differs per bank
    core_bank = _word_bank(rng, n_clusters * core_words, syllables=2)
    dist_bank = _word_bank(rng, num_targets * distinct_words, syllables=3)
    noise_bank = _word_bank(rng, 400, syllables=4)
    noise_w = [1.0 / (i + 1) for i in range(len(noise_bank))]  # Zipf
    core_w = [1.0 / (i + 1) for i in range(core_words)]

    if task == "crosslingual":
        src_side = _word_bank(rng, len(core_bank) + len(dist_bank), syllables=5)
        translate: Dict[str, str] = dict(
            zip(core_bank + dist_bank, src_side)
        )
    else:
        translate = {w: w for w in core_bank + dist_bank}

    cores = [
        core_bank[c * core_words : (c + 1) * core_words]
        for c in range(n_clusters)
    ]
    distincts = [
        dist_bank[i * distinct_words : (i + 1) * distinct_words]
        for i in range(num_targets)
    ]

    target_rows: List[Tuple[str, str]] = []
    for i in range(num_targets):
        core = cores[i // cluster_size]
        if task == "classification":  # category-name-like: short
            text = " ".join(distincts[i] + core[:2])
        elif task == "qna":  # answer-passage-like: long
            text = " ".join(core + distincts[i] + rng.sample(noise_bank, 3))
        else:
            text = " ".join(core + distincts[i])
        target_rows.append((f"t{i:05d}", text))

    def draw_source(i: int, r: random.Random, core_only: bool) -> str:
        core = cores[i // cluster_size]
        words = []
        for _ in range(src_words):
            if not core_only and r.random() < p_distinct:
                words.append(translate[r.choice(distincts[i])])
            else:
                words.append(translate[r.choices(core, weights=core_w)[0]])
        words += r.choices(noise_bank, weights=noise_w, k=noise_words)
        r.shuffle(words)
        return " ".join(words)

    def sample(count: int, r: random.Random, multi: float):
        pairs = []
        for i in range(num_targets):
            for _ in range(count):
                if r.random() < multi and cluster_size > 1:
                    # ambiguous-by-construction row: core words only, two
                    # siblings both count as correct
                    c = i // cluster_size
                    sib = r.choice(
                        [
                            j
                            for j in range(
                                c * cluster_size, (c + 1) * cluster_size
                            )
                            if j != i
                        ]
                    )
                    pairs.append(
                        (
                            draw_source(i, r, core_only=True),
                            [f"t{i:05d}", f"t{sib:05d}"],
                        )
                    )
                else:
                    pairs.append(
                        (draw_source(i, r, core_only=False), [f"t{i:05d}"])
                    )
        r.shuffle(pairs)
        return pairs

    # train_multi_label_frac > 0 matches the train distribution to eval:
    # ambiguous core-only sources carry BOTH sibling labels (the
    # reference's multi-id TSV convention), which the label-set-aware
    # loss masks instead of treating the sibling as a negative
    train_pairs = sample(
        train_per_target, random.Random(seed + 1), train_multi_label_frac
    )
    eval_pairs = sample(
        eval_per_target, random.Random(seed + 2), multi_label_frac
    )
    return train_pairs, eval_pairs, target_rows


def make_compositional_corpus(
    task: str = "ranking",
    num_targets: int = 2048,
    cluster_size: int = 8,
    train_per_target: int = 32,
    eval_per_target: int = 2,
    window_min: int = 2,
    window_max: int = 5,
    noise_words: int = 2,
    seed: int = 0,
) -> Tuple[List[Tuple[str, List[str]]], List[Tuple[str, List[str]]], List[Tuple[str, str]]]:
    """The ORDER-SENSITIVE benchmark profile (round-3 instrument).

    The hard profile's signal is entirely lexical: its word-overlap
    oracle equals its Bayes-optimal scorer (0.7795, tools/bayes_oracle.py)
    so a bag-of-words tower matches the ceiling and sequence encoders
    cannot demonstrate their advantage. This profile makes word IDENTITY
    deliberately useless within a cluster and puts the label signal in
    word ORDER instead:

      * each cluster of ``cluster_size`` targets shares ONE pool of
        ``cluster_size`` words; every target's text is a distinct
        PERMUTATION of the full pool — all siblings have byte-identical
        bags of words, so any order-blind scorer is at chance 1/cluster
        within the cluster (recall@1 ≈ 1/cluster_size; recall@10 still
        saturates when cluster_size ≤ 10 — recall@1 is the metric here);
      * a source is a CONTIGUOUS window (length uniform in
        [window_min, window_max]) of its target's permutation, with
        ``noise_words`` Zipf-drawn 4-syllable noise words appended at
        the ends (cluster words are 2-syllable, so noise is
        membership-identifiable and never perturbs window adjacencies);
      * the Bayes-optimal scorer is computable in closed form: strip
        noise, then the posterior is uniform over targets whose
        permutation contains the window as a contiguous subsequence
        (tools/comp_oracle.py measures it exactly, along with the
        word-overlap and bigram-overlap oracles). Short windows are
        irreducibly ambiguous — an ordered pair is adjacent in a random
        sibling permutation with prob 1/cluster_size — which keeps the
        ceiling below 1.0 and measurable.

    A model beats the BoW oracle here ONLY by encoding order (bigrams or
    better): the gap between the word-overlap oracle and the bigram
    oracle is the instrument's discriminative range. Same schema/return
    shape as make_corpus; crosslingual maps source words through a
    bijection into a disjoint vocabulary (order signal preserved), qna
    appends noise to target passages.
    """
    if task not in ("classification", "ranking", "crosslingual", "qna"):
        raise ValueError(f"unknown task {task!r}")
    if num_targets % cluster_size:
        raise ValueError("num_targets must be a multiple of cluster_size")
    if not (1 <= window_min <= window_max <= cluster_size):
        raise ValueError("need 1 <= window_min <= window_max <= cluster_size")
    rng = random.Random(seed)
    n_clusters = num_targets // cluster_size
    pool_bank = _word_bank(rng, n_clusters * cluster_size, syllables=2)
    noise_bank = _word_bank(rng, 400, syllables=4)
    noise_w = [1.0 / (i + 1) for i in range(len(noise_bank))]  # Zipf

    if task == "crosslingual":
        src_side = _word_bank(rng, len(pool_bank), syllables=5)
        translate: Dict[str, str] = dict(zip(pool_bank, src_side))
    else:
        translate = {w: w for w in pool_bank}

    pools = [
        pool_bank[c * cluster_size : (c + 1) * cluster_size]
        for c in range(n_clusters)
    ]
    # distinct permutations per cluster (collision-free by construction)
    perms: List[List[str]] = []
    target_rows: List[Tuple[str, str]] = []
    for c in range(n_clusters):
        seen = set()
        for i in range(cluster_size):
            while True:
                p = pools[c][:]
                rng.shuffle(p)
                key = tuple(p)
                if key not in seen:
                    seen.add(key)
                    break
            perms.append(p)
            tid = c * cluster_size + i
            text = " ".join(p)
            if task == "qna":  # answer-passage-like: longer
                text += " " + " ".join(rng.sample(noise_bank, 3))
            target_rows.append((f"t{tid:05d}", text))

    def draw_source(i: int, r: random.Random) -> str:
        p = perms[i]
        s = r.randint(window_min, window_max)
        lo = r.randint(0, len(p) - s)
        words = [translate[w] for w in p[lo : lo + s]]
        # noise at the ENDS only — window adjacencies stay intact
        pre = r.randint(0, noise_words)
        nz = r.choices(noise_bank, weights=noise_w, k=noise_words)
        return " ".join(nz[:pre] + words + nz[pre:])

    def sample(count: int, r: random.Random):
        pairs = []
        for i in range(num_targets):
            for _ in range(count):
                pairs.append((draw_source(i, r), [f"t{i:05d}"]))
        r.shuffle(pairs)
        return pairs

    train_pairs = sample(train_per_target, random.Random(seed + 1))
    eval_pairs = sample(eval_per_target, random.Random(seed + 2))
    return train_pairs, eval_pairs, target_rows


def _word_at(i: int, syllables: int = 3) -> str:
    """Deterministic unique word for an index (no bank materialization —
    the scale profile needs 10M-target corpora where rejection-sampled
    banks would be the bottleneck)."""
    out = []
    for _ in range(syllables):
        out.append(_CONSONANTS[i % len(_CONSONANTS)])
        out.append(_VOWELS[(i // len(_CONSONANTS)) % len(_VOWELS)])
        i //= len(_CONSONANTS) * len(_VOWELS)
    return "".join(out)


def write_scale_corpus(
    out_dir: str,
    num_targets: int = 10_000_000,
    train_rows: int = 16_384,
    eval_rows: int = 4_096,
    vocab_words: int = 100_000,
    words_per_target: int = 6,
    src_words: int = 4,
    seed: int = 0,
) -> None:
    """The SCALE profile: a corpus sized for index/serving capstones
    (10M+ targets), streamed straight to disk — reference schema, no
    cluster structure (quality is the HARD profile's job; this one
    exists so `index`/`eval --use_index`/`serve` can be driven at the
    north star's corpus size through the real CLI stack). Sources are
    word subsets of their target's text plus one noise word, so a
    correctly-built index retrieves them with high recall."""
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    words = [_word_at(i) for i in range(vocab_words)]
    widx = rng.integers(
        0, vocab_words, size=(num_targets, words_per_target), dtype=np.int64
    )
    with open(
        os.path.join(out_dir, "targetIDs"), "w", encoding="utf-8"
    ) as f:
        for i in range(num_targets):
            text = " ".join(words[j] for j in widx[i])
            f.write(f"t{i:08d}\t{text}\n")

    def write_pairs(path: str, n: int, prng):
        rows = prng.integers(0, num_targets, size=(n,), dtype=np.int64)
        with open(path, "w", encoding="utf-8") as f:
            for r in rows:
                pick = prng.permutation(words_per_target)[:src_words]
                ws = [words[widx[r, p]] for p in pick]
                ws.append(words[int(prng.integers(0, vocab_words))])
                f.write(f"{' '.join(ws)}\tt{r:08d}\n")

    write_pairs(
        os.path.join(out_dir, "TrainPairs"), train_rows,
        np.random.default_rng(seed + 1),
    )
    write_pairs(
        os.path.join(out_dir, "EvalPairs"), eval_rows,
        np.random.default_rng(seed + 2),
    )


def write_corpus(
    out_dir: str,
    train_pairs: Sequence[Tuple[str, List[str]]],
    eval_pairs: Sequence[Tuple[str, List[str]]],
    target_rows: Sequence[Tuple[str, str]],
) -> None:
    """Write TrainPairs / EvalPairs / targetIDs TSVs (reference filenames,
    SURVEY.md §2.1 demo-datasets row)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "TrainPairs"), "w", encoding="utf-8") as f:
        for src, tids in train_pairs:
            f.write(f"{src}\t{','.join(tids)}\n")
    with open(os.path.join(out_dir, "EvalPairs"), "w", encoding="utf-8") as f:
        for src, tids in eval_pairs:
            f.write(f"{src}\t{','.join(tids)}\n")
    with open(os.path.join(out_dir, "targetIDs"), "w", encoding="utf-8") as f:
        for tid, text in target_rows:
            f.write(f"{tid}\t{text}\n")
