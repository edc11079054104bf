// Native subword encoder for the PyTorch port: the host side's text hot
// loops in C++ (a copy of the JAX package's sse_tpu/native/encoder.cpp,
// same C ABI, same rules).
//
// Three loops, each bit-identical to its pure-Python version in
// sse_tpu_torch/text/subword.py:
//   * encoding: tokenize -> escape -> greedy longest-match segmentation
//     (Encoder; sse_encode, and sse_encode_batch with the data layer's
//     padding convention), the path of every served query, live add,
//     index build and pair encode;
//   * token counting over corpus lines (TokenCounter; sse_counter_*);
//   * the vocabulary build, build_from_token_counts (BuildVocab;
//     sse_vocab_*), whose candidate counting runs on up to 16 threads.
//
// Exposed as a C ABI for ctypes. Host code, built with the host C++
// compiler at first use (sse_tpu_torch/native/binding.py):
//   c++ -O2 -std=c++17 -shared -fPIC -pthread encoder.cpp -o libsse_encoder.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint32_t kEnd = '_';

// ---------------------------------------------------------------- utf-8
// Decode one UTF-8 char at p (len bytes available); returns codepoint and
// advances *consumed. Invalid bytes decode as U+FFFD over 1 byte (Python
// strings can't contain invalid sequences, so this path is defensive only).
// A lone surrogate, which the binding encodes with "surrogatepass", decodes
// to its own code point, one character as in Python.
uint32_t DecodeUtf8(const char* p, size_t len, size_t* consumed) {
  const unsigned char b0 = static_cast<unsigned char>(p[0]);
  if (b0 < 0x80) {
    *consumed = 1;
    return b0;
  }
  int n;
  uint32_t cp;
  if ((b0 & 0xE0) == 0xC0) {
    n = 2;
    cp = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    n = 3;
    cp = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    n = 4;
    cp = b0 & 0x07;
  } else {
    *consumed = 1;
    return 0xFFFD;
  }
  if (static_cast<size_t>(n) > len) {
    *consumed = 1;
    return 0xFFFD;
  }
  for (int i = 1; i < n; ++i) {
    const unsigned char bi = static_cast<unsigned char>(p[i]);
    if ((bi & 0xC0) != 0x80) {
      *consumed = 1;
      return 0xFFFD;
    }
    cp = (cp << 6) | (bi & 0x3F);
  }
  *consumed = n;
  return cp;
}

void AppendUtf8(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// ------------------------------------------------------------ byte trie
// Greedy longest-match over escaped-token bytes. Nodes in a flat vector;
// children in a per-node hash map (vocab is small, build once).
struct TrieNode {
  int32_t id = -1;  // subtoken id if a vocab entry ends here
  std::unordered_map<unsigned char, int32_t> next;
};

struct Encoder {
  std::vector<TrieNode> trie;
  std::unordered_set<uint32_t> alphabet;      // codepoints
  std::vector<std::pair<uint32_t, uint32_t>> alnum_ranges;  // sorted

  bool IsAlnum(uint32_t cp) const {
    // binary search over [lo, hi] ranges
    size_t lo = 0, hi = alnum_ranges.size();
    while (lo < hi) {
      const size_t mid = (lo + hi) / 2;
      if (cp < alnum_ranges[mid].first) {
        hi = mid;
      } else if (cp > alnum_ranges[mid].second) {
        lo = mid + 1;
      } else {
        return true;
      }
    }
    return false;
  }

  void AddSubtoken(const char* bytes, int32_t len, int32_t id) {
    int32_t node = 0;
    for (int32_t i = 0; i < len; ++i) {
      const unsigned char b = static_cast<unsigned char>(bytes[i]);
      auto it = trie[node].next.find(b);
      if (it == trie[node].next.end()) {
        trie.emplace_back();
        trie[node].next.emplace(b, static_cast<int32_t>(trie.size() - 1));
        node = static_cast<int32_t>(trie.size() - 1);
      } else {
        node = it->second;
      }
    }
    if (trie[node].id < 0) trie[node].id = id;  // first writer wins (dup-safe)
  }

  // Longest match starting at escaped[pos]; returns (id, match_bytes) or
  // id -1 when no vocab entry matches (caller skips one char).
  std::pair<int32_t, size_t> Longest(const std::string& escaped,
                                     size_t pos) const {
    int32_t node = 0;
    int32_t best_id = -1;
    size_t best_len = 0;
    for (size_t i = pos; i < escaped.size(); ++i) {
      const unsigned char b = static_cast<unsigned char>(escaped[i]);
      auto it = trie[node].next.find(b);
      if (it == trie[node].next.end()) break;
      node = it->second;
      if (trie[node].id >= 0) {
        best_id = trie[node].id;
        best_len = i - pos + 1;
      }
    }
    return {best_id, best_len};
  }

  // tokenize → escape → segment, appending ids to out.
  void EncodeText(const char* text, size_t len, std::vector<int32_t>* out) const {
    // Pass 1: invertible run tokenizer (sse_tpu_torch/text/tokenizer.py rules).
    // We stream runs; a lone " " between two alnum runs is dropped.
    size_t pos = 0;
    size_t run_start = 0;
    bool prev_alnum = false;
    bool first = true;
    std::vector<std::pair<size_t, size_t>> runs;  // byte ranges
    while (pos < len) {
      size_t used;
      const uint32_t cp = DecodeUtf8(text + pos, len - pos, &used);
      const bool cur = IsAlnum(cp);
      if (first) {
        prev_alnum = cur;
        first = false;
      } else if (cur != prev_alnum) {
        const size_t rl = pos - run_start;
        if (!(rl == 1 && text[run_start] == ' ' && run_start != 0)) {
          runs.emplace_back(run_start, pos);
        }
        run_start = pos;
        prev_alnum = cur;
      }
      pos += used;
    }
    if (len > 0) runs.emplace_back(run_start, len);

    std::string escaped;
    for (const auto& r : runs) {
      // Pass 2: escape this token.
      escaped.clear();
      size_t p = r.first;
      while (p < r.second) {
        size_t used;
        const uint32_t cp = DecodeUtf8(text + p, r.second - p, &used);
        if (cp == '\\') {
          escaped += "\\\\";
        } else if (cp == kEnd) {
          escaped += "\\u";
        } else if (cp != '\n' && alphabet.count(cp)) {
          escaped.append(text + p, used);
        } else {
          escaped += '\\';
          escaped += std::to_string(cp);
          escaped += ';';
        }
        p += used;
      }
      escaped += '_';

      // Pass 3: greedy longest-match segmentation.
      size_t q = 0;
      while (q < escaped.size()) {
        auto [id, mlen] = Longest(escaped, q);
        if (id >= 0) {
          out->push_back(id);
          q += mlen;
        } else {  // foreign char w.r.t. vocab: skip one UTF-8 char
          size_t used;
          DecodeUtf8(escaped.c_str() + q, escaped.size() - q, &used);
          q += used;
        }
      }
    }
  }
};

// ------------------------------------------------------------ token counts
// Vocab prep's other hot loop: tokenize every corpus line
// and count tokens. Same run-splitting rules as Encoder::EncodeText.
struct TokenCounter {
  std::vector<std::pair<uint32_t, uint32_t>> alnum_ranges;
  std::unordered_map<std::string, int64_t> counts;

  bool IsAlnum(uint32_t cp) const {
    size_t lo = 0, hi = alnum_ranges.size();
    while (lo < hi) {
      const size_t mid = (lo + hi) / 2;
      if (cp < alnum_ranges[mid].first) {
        hi = mid;
      } else if (cp > alnum_ranges[mid].second) {
        lo = mid + 1;
      } else {
        return true;
      }
    }
    return false;
  }

  void AddLine(const char* text, size_t len) {
    size_t pos = 0, run_start = 0;
    bool prev_alnum = false, first = true;
    auto flush = [&](size_t end) {
      const size_t rl = end - run_start;
      if (!(rl == 1 && text[run_start] == ' ' && run_start != 0)) {
        counts[std::string(text + run_start, rl)] += 1;
      }
    };
    while (pos < len) {
      size_t used;
      const uint32_t cp = DecodeUtf8(text + pos, len - pos, &used);
      const bool cur = IsAlnum(cp);
      if (first) {
        prev_alnum = cur;
        first = false;
      } else if (cur != prev_alnum) {
        flush(pos);
        run_start = pos;
        prev_alnum = cur;
      }
      pos += used;
    }
    if (len > 0) counts[std::string(text + run_start, len - run_start)] += 1;
  }
};

// ---------------------------------------------------------- vocab builder
// build_from_token_counts in C++ (bit-identical to subword.py): the
// O(len^2)-per-token candidate loop is the one-time CPU cost that gates
// every new corpus. All string work happens
// in CODEPOINT space (std::u32string) because Python slices by codepoint;
// UTF-8 byte order == codepoint order, so lexicographic ties sort the same.
using U32 = std::u32string;

struct U32Hash {
  size_t operator()(const U32& s) const {
    size_t h = 1469598103934665603ull;
    for (char32_t c : s) {
      h ^= static_cast<size_t>(c);
      h *= 1099511628211ull;
    }
    return h;
  }
};

// Greedy longest-match trie over codepoints (vocab rebuilt per iteration).
struct U32Trie {
  struct Node {
    int32_t terminal = 0;  // 1 when a subtoken ends here
    std::unordered_map<char32_t, int32_t> next;
  };
  std::vector<Node> nodes;
  size_t max_len = 1;

  U32Trie() { nodes.emplace_back(); }

  void Add(const U32& s) {
    int32_t node = 0;
    for (char32_t c : s) {
      auto it = nodes[node].next.find(c);
      if (it == nodes[node].next.end()) {
        nodes.emplace_back();
        nodes[node].next.emplace(c, static_cast<int32_t>(nodes.size() - 1));
        node = static_cast<int32_t>(nodes.size() - 1);
      } else {
        node = it->second;
      }
    }
    nodes[node].terminal = 1;
    if (s.size() > max_len) max_len = s.size();
  }

  // Length (codepoints) of the longest subtoken matching at s[pos..];
  // 0 when nothing matches (Python skips one char in that case).
  size_t Longest(const U32& s, size_t pos) const {
    int32_t node = 0;
    size_t best = 0;
    for (size_t i = pos; i < s.size(); ++i) {
      auto it = nodes[node].next.find(s[i]);
      if (it == nodes[node].next.end()) break;
      node = it->second;
      if (nodes[node].terminal) best = i - pos + 1;
    }
    return best;
  }
};

struct VocabBuilder {
  std::vector<std::string> subtokens;  // final order, UTF-8
};

// subword.py::_ESCAPE_CHARS, forced into the alphabet.
const char32_t kEscapeChars[] = U"\\_u;0123456789";

VocabBuilder* BuildVocab(const char* blob, const int64_t* offsets,
                         const int64_t* counts, int64_t n_tokens,
                         int64_t min_count, int32_t num_iterations,
                         int32_t max_subtoken_length) {
  // ---- decode tokens, collect alphabet --------------------------------
  std::vector<U32> tokens(n_tokens);
  std::unordered_set<char32_t> alphabet;
  for (int64_t i = 0; i < n_tokens; ++i) {
    const char* p = blob + offsets[i];
    size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    size_t pos = 0;
    while (pos < len) {
      size_t used;
      const uint32_t cp = DecodeUtf8(p + pos, len - pos, &used);
      tokens[i].push_back(static_cast<char32_t>(cp));
      alphabet.insert(static_cast<char32_t>(cp));
      pos += used;
    }
  }
  for (const char32_t* c = kEscapeChars; *c; ++c) alphabet.insert(*c);

  // ---- escape tokens (dict-comprehension semantics: escape is injective
  // so plain assignment matches Python's last-write-wins) ---------------
  std::unordered_map<U32, int64_t, U32Hash> escaped_counts;
  escaped_counts.reserve(static_cast<size_t>(n_tokens) * 2);
  for (int64_t i = 0; i < n_tokens; ++i) {
    U32 esc;
    esc.reserve(tokens[i].size() + 1);
    for (char32_t c : tokens[i]) {
      if (c == U'\\') {
        esc += U"\\\\";
      } else if (c == U'_') {
        esc += U"\\u";
      } else if (c != U'\n' && alphabet.count(c)) {
        esc.push_back(c);
      } else {
        esc.push_back(U'\\');
        const std::string dec = std::to_string(static_cast<uint32_t>(c));
        for (char d : dec) esc.push_back(static_cast<char32_t>(d));
        esc.push_back(U';');
      }
    }
    esc.push_back(U'_');
    escaped_counts[esc] = counts[i];
  }

  // ---- iteration-0 vocab: sorted alphabet ------------------------------
  std::vector<char32_t> alpha_sorted(alphabet.begin(), alphabet.end());
  std::sort(alpha_sorted.begin(), alpha_sorted.end());
  std::vector<U32> vocab;
  vocab.reserve(alpha_sorted.size());
  for (char32_t c : alpha_sorted) vocab.push_back(U32(1, c));

  // Stable arena of (escaped string, count): candidate keys are VIEWS into
  // it, so the hot counting loop never allocates key storage.
  std::vector<std::pair<U32, int64_t>> escaped_list(
      std::make_move_iterator(escaped_counts.begin()),
      std::make_move_iterator(escaped_counts.end()));
  using View = std::u32string_view;
  struct ViewHash {
    size_t operator()(const View& s) const {
      size_t h = 1469598103934665603ull;
      for (char32_t c : s) {
        h ^= static_cast<size_t>(c);
        h *= 1099511628211ull;
      }
      return h;
    }
  };

  // Open-addressing candidate table: std::unordered_map spends the bulk of
  // the counting loop in per-node malloc + pointer chasing; a flat
  // linear-probe table with view keys makes the loop allocation-free.
  struct FlatCand {
    struct Slot {
      const char32_t* ptr = nullptr;
      uint32_t len = 0;
      int64_t cnt = 0;
      size_t hash = 0;
    };
    std::vector<Slot> slots;
    size_t mask = 0;
    size_t size_ = 0;

    explicit FlatCand(size_t cap = 1 << 16) {
      size_t n = 1 << 10;
      while (n < cap * 2) n <<= 1;
      slots.assign(n, Slot());
      mask = n - 1;
    }

    static size_t HashOf(const char32_t* p, uint32_t len) {
      size_t h = 1469598103934665603ull;
      for (uint32_t i = 0; i < len; ++i) {
        h ^= static_cast<size_t>(p[i]);
        h *= 1099511628211ull;
      }
      return h;
    }

    void Grow() {
      std::vector<Slot> old;
      old.swap(slots);
      slots.assign(old.size() * 2, Slot());
      mask = slots.size() - 1;
      for (const Slot& s : old) {
        if (!s.ptr) continue;
        size_t i = s.hash & mask;
        while (slots[i].ptr) i = (i + 1) & mask;
        slots[i] = s;
      }
    }

    int64_t* FindOrInsert(const char32_t* p, uint32_t len, size_t h) {
      if (size_ * 10 >= slots.size() * 7) Grow();
      size_t i = h & mask;
      for (;;) {
        Slot& s = slots[i];
        if (!s.ptr) {
          s.ptr = p;
          s.len = len;
          s.hash = h;
          ++size_;
          return &s.cnt;
        }
        if (s.hash == h && s.len == len &&
            (s.ptr == p ||
             std::memcmp(s.ptr, p, static_cast<size_t>(len) * 4) == 0)) {
          return &s.cnt;
        }
        i = (i + 1) & mask;
      }
    }

    // nullptr when absent (no insert) — for read-mostly lookups.
    int64_t* Find(const char32_t* p, uint32_t len) {
      const size_t h = HashOf(p, len);
      size_t i = h & mask;
      for (;;) {
        Slot& s = slots[i];
        if (!s.ptr) return nullptr;
        if (s.hash == h && s.len == len &&
            (s.ptr == p ||
             std::memcmp(s.ptr, p, static_cast<size_t>(len) * 4) == 0)) {
          return &s.cnt;
        }
        i = (i + 1) & mask;
      }
    }
  };

  const size_t n_threads =
      std::max<size_t>(1, std::min<size_t>(std::thread::hardware_concurrency(),
                                           16));

  for (int32_t iter = 0; iter < num_iterations; ++iter) {
    U32Trie trie;
    for (const U32& s : vocab) trie.Add(s);

    // candidate counting at segmentation boundaries — integer sums, so
    // sharding over threads and merging is exact regardless of order
    std::vector<FlatCand> shards;
    shards.reserve(n_threads);
    for (size_t t = 0; t < n_threads; ++t) shards.emplace_back(1 << 16);
    auto count_range = [&](size_t t0, size_t t1, FlatCand* cand) {
      for (size_t ti = t0; ti < t1; ++ti) {
        const U32& esc = escaped_list[ti].first;
        const int64_t cnt = escaped_list[ti].second;
        size_t start = 0;
        while (start < esc.size()) {
          size_t mlen = trie.Longest(esc, start);
          size_t limit = esc.size();
          if (max_subtoken_length > 0) {
            const size_t cap =
                start + static_cast<size_t>(max_subtoken_length);
            if (cap < limit) limit = cap;
          }
          if (mlen > 0) {
            const char32_t* base = esc.data() + start;
            // incremental FNV: hash of base[0..l) extends to l+1 in O(1),
            // so candidate counting is O(candidates), not O(candidates·len)
            size_t h = 1469598103934665603ull;
            for (size_t end = start + 1; end <= limit; ++end) {
              h ^= static_cast<size_t>(base[end - start - 1]);
              h *= 1099511628211ull;
              *cand->FindOrInsert(
                  base, static_cast<uint32_t>(end - start), h) += cnt;
            }
            start += mlen;
          } else {
            start += 1;  // foreign char: Python's skip (no candidates)
          }
        }
      }
    };
    if (n_threads == 1 || escaped_list.size() < 1024) {
      count_range(0, escaped_list.size(), &shards[0]);
    } else {
      std::vector<std::thread> threads;
      const size_t per = (escaped_list.size() + n_threads - 1) / n_threads;
      for (size_t t = 0; t < n_threads; ++t) {
        const size_t lo = t * per;
        const size_t hi = std::min(escaped_list.size(), lo + per);
        if (lo >= hi) break;
        threads.emplace_back(count_range, lo, hi, &shards[t]);
      }
      for (auto& th : threads) th.join();
    }
    FlatCand& cand = shards[0];
    for (size_t t = 1; t < shards.size(); ++t) {
      for (const auto& s : shards[t].slots) {
        if (s.ptr) *cand.FindOrInsert(s.ptr, s.len, s.hash) += s.cnt;
      }
      std::vector<FlatCand::Slot>().swap(shards[t].slots);
    }

    // longest-first selection with prefix-count subtraction
    std::vector<std::vector<View>> by_len;
    for (const auto& s : cand.slots) {
      if (s.ptr && s.cnt >= min_count) {
        const size_t l = s.len;
        if (by_len.size() <= l) by_len.resize(l + 1);
        by_len[l].push_back(View(s.ptr, s.len));
      }
    }
    std::vector<std::pair<int64_t, U32>> winners;
    for (size_t length = by_len.size(); length-- > 0;) {
      for (const View& sub : by_len[length]) {
        int64_t* pc = cand.Find(sub.data(), static_cast<uint32_t>(sub.size()));
        const int64_t cnt = *pc;  // present by construction
        if (cnt < min_count) continue;
        if (length > 1) winners.emplace_back(cnt, U32(sub));
        for (size_t l = 1; l < length; ++l) {
          // prefixes share sub's base pointer: FindOrInsert may introduce
          // a fresh entry (Python's defaultdict does the same)
          *cand.FindOrInsert(
              sub.data(), static_cast<uint32_t>(l),
              FlatCand::HashOf(sub.data(), static_cast<uint32_t>(l))) -= cnt;
        }
      }
    }
    for (char32_t c : alpha_sorted) {
      const U32 s(1, c);
      int64_t* pc = cand.Find(s.data(), 1);
      winners.emplace_back(pc ? *pc : 0, s);
    }
    std::sort(winners.begin(), winners.end(),
              [](const std::pair<int64_t, U32>& a,
                 const std::pair<int64_t, U32>& b) {
                if (a.first != b.first) return a.first > b.first;
                return a.second < b.second;  // codepoint order == Python str
              });
    vocab.clear();
    vocab.reserve(winners.size());
    for (auto& w : winners) vocab.push_back(std::move(w.second));
  }

  auto* out = new VocabBuilder();
  out->subtokens.reserve(vocab.size());
  for (const U32& s : vocab) {
    std::string utf8;
    utf8.reserve(s.size() * 2);
    for (char32_t c : s) AppendUtf8(static_cast<uint32_t>(c), &utf8);
    out->subtokens.push_back(std::move(utf8));
  }
  return out;
}

}  // namespace

extern "C" {

void* sse_counter_create(const uint32_t* ranges, int32_t n_ranges) {
  auto* c = new TokenCounter();
  c->alnum_ranges.reserve(n_ranges);
  for (int32_t i = 0; i < n_ranges; ++i) {
    c->alnum_ranges.emplace_back(ranges[2 * i], ranges[2 * i + 1]);
  }
  return c;
}

void sse_counter_destroy(void* c) { delete static_cast<TokenCounter*>(c); }

// Native build_from_token_counts. tokens: concatenated UTF-8 bytes with
// n+1 offsets; counts per token. max_subtoken_length 0 = unbounded.
// Bit-identical output order to SubwordVocab.build_from_token_counts
// (golden-file gated in tests). Two-phase dump like the counter.
void* sse_vocab_build(const char* blob, const int64_t* offsets,
                      const int64_t* counts, int64_t n_tokens,
                      int64_t min_count, int32_t num_iterations,
                      int32_t max_subtoken_length) {
  return BuildVocab(blob, offsets, counts, n_tokens, min_count,
                    num_iterations, max_subtoken_length);
}

void sse_vocab_destroy(void* v) { delete static_cast<VocabBuilder*>(v); }

void sse_vocab_sizes(void* v, int64_t* n_subtokens, int64_t* total_bytes) {
  auto* b = static_cast<VocabBuilder*>(v);
  *n_subtokens = static_cast<int64_t>(b->subtokens.size());
  int64_t bytes = 0;
  for (const auto& s : b->subtokens) bytes += s.size();
  *total_bytes = bytes;
}

void sse_vocab_dump(void* v, char* blob_out, int32_t* lens_out) {
  auto* b = static_cast<VocabBuilder*>(v);
  char* p = blob_out;
  int64_t i = 0;
  for (const auto& s : b->subtokens) {
    std::memcpy(p, s.data(), s.size());
    p += s.size();
    lens_out[i++] = static_cast<int32_t>(s.size());
  }
}

void sse_counter_add(void* c, const char* blob, const int64_t* offsets,
                     int32_t n) {
  auto* counter = static_cast<TokenCounter*>(c);
  for (int32_t i = 0; i < n; ++i) {
    counter->AddLine(blob + offsets[i],
                     static_cast<size_t>(offsets[i + 1] - offsets[i]));
  }
}

// Two-phase dump: sizes() reports (n_tokens, total_bytes); dump() fills
// caller-allocated buffers (concatenated token bytes, per-token byte
// lengths, per-token counts).
void sse_counter_sizes(void* c, int64_t* n_tokens, int64_t* total_bytes) {
  auto* counter = static_cast<TokenCounter*>(c);
  *n_tokens = static_cast<int64_t>(counter->counts.size());
  int64_t bytes = 0;
  for (const auto& kv : counter->counts) bytes += kv.first.size();
  *total_bytes = bytes;
}

void sse_counter_dump(void* c, char* blob_out, int32_t* lens_out,
                      int64_t* counts_out) {
  auto* counter = static_cast<TokenCounter*>(c);
  char* p = blob_out;
  int64_t i = 0;
  for (const auto& kv : counter->counts) {
    std::memcpy(p, kv.first.data(), kv.first.size());
    p += kv.first.size();
    lens_out[i] = static_cast<int32_t>(kv.first.size());
    counts_out[i] = kv.second;
    ++i;
  }
}

// blob: concatenated UTF-8 subtoken bytes; lens[i] = byte length of
// subtoken i (id = i + id_offset). ranges: 2*n_ranges uint32 lo/hi pairs
// of alphanumeric codepoint ranges (from Python's unicodedata, so both
// sides agree on the tokenizer's character classes).
void* sse_encoder_create(const char* blob, const int32_t* lens, int32_t n,
                         int32_t id_offset, const uint32_t* ranges,
                         int32_t n_ranges) {
  auto* enc = new Encoder();
  enc->trie.emplace_back();  // root
  const char* p = blob;
  for (int32_t i = 0; i < n; ++i) {
    enc->AddSubtoken(p, lens[i], i + id_offset);
    // single-char subtokens define the escape alphabet (subword.py ctor)
    size_t used;
    const uint32_t cp = DecodeUtf8(p, lens[i], &used);
    if (static_cast<int32_t>(used) == lens[i]) enc->alphabet.insert(cp);
    p += lens[i];
  }
  enc->alnum_ranges.reserve(n_ranges);
  for (int32_t i = 0; i < n_ranges; ++i) {
    enc->alnum_ranges.emplace_back(ranges[2 * i], ranges[2 * i + 1]);
  }
  return enc;
}

void sse_encoder_destroy(void* enc) { delete static_cast<Encoder*>(enc); }

// Encode one string; returns the number of ids (truncated to max_out).
int32_t sse_encode(void* enc, const char* text, int32_t text_len,
                   int32_t* out, int32_t max_out) {
  std::vector<int32_t> ids;
  static_cast<Encoder*>(enc)->EncodeText(text, text_len, &ids);
  const int32_t n = static_cast<int32_t>(
      ids.size() > static_cast<size_t>(max_out) ? max_out : ids.size());
  std::memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

// Batch encode with the data layer's padding convention: each row is
// truncated to max_len-1 ids, EOS-terminated, zero-padded (mirrors
// sse_tpu_torch/data/corpus.py::_encode_line). offsets has n+1 entries into blob.
void sse_encode_batch(void* enc, const char* blob, const int64_t* offsets,
                      int32_t n, int32_t max_len, int32_t eos_id,
                      int32_t* out_tokens, int32_t* out_lengths) {
  auto* e = static_cast<Encoder*>(enc);
  std::vector<int32_t> ids;
  for (int32_t i = 0; i < n; ++i) {
    ids.clear();
    e->EncodeText(blob + offsets[i],
                  static_cast<size_t>(offsets[i + 1] - offsets[i]), &ids);
    int32_t m = static_cast<int32_t>(ids.size());
    if (m > max_len - 1) m = max_len - 1;
    int32_t* row = out_tokens + static_cast<int64_t>(i) * max_len;
    std::memcpy(row, ids.data(), m * sizeof(int32_t));
    row[m] = eos_id;
    for (int32_t j = m + 1; j < max_len; ++j) row[j] = 0;
    out_lengths[i] = m + 1;
  }
}

}  // extern "C"
