// First-party inverted-index (postings) builder.
//
// The PyTorch port's own copy of raglite_tpu/native/postings.cpp (host code,
// unchanged; the port imports nothing of the JAX package). It replaces the
// index-build half of DuckDB's FTS extension
// (PRAGMA create_fts_index, raglite/_database.py:606-619):
// tokenization, term dictionary, term-frequency accumulation, CSR postings
// export, and binary serialization all run here; BM25 *scoring* runs on the
// device (raglite_tpu_torch/ops/bm25.py) over the CSR arrays this builder
// emits. The sentence and chunklet DPs below are the fast paths of
// sentences.py and chunklets.py.
//
// Exposed as a C API consumed via ctypes (raglite_tpu_torch/native/__init__.py).
// Build: g++ -O3 -shared -fPIC -std=c++17 postings.cpp -o libraglite_postings.so
//
// Tokenizer: UTF-8 aware. A codepoint is a word character iff it is ASCII
// [a-z0-9_] (after ASCII lowercasing) or a non-ASCII codepoint outside the
// common Unicode punctuation/space blocks. This matches Python's \w over
// lowercased text for ASCII and the overwhelmingly common non-ASCII cases;
// the Python fallback tokenizer (index/keyword.py:tokenize) mirrors it.

#include <cstdint>
#include <cmath>
#include <algorithm>
#include <cstring>
#include <cstdio>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Builder {
  // term -> term id
  std::unordered_map<std::string, int32_t> dict;
  // term id -> (chunk ordinal, tf) pairs, appended in chunk order
  std::vector<std::vector<std::pair<int32_t, int32_t>>> postings;
  std::vector<std::string> terms;      // term id -> term bytes
  std::vector<int32_t> doc_len;        // chunk ordinal -> token count
  // scratch: per-chunk term counts (term id -> tf), reused across chunks
  std::unordered_map<int32_t, int32_t> chunk_tf;
};

inline bool is_unicode_punct(uint32_t cp) {
  // Common punctuation / space blocks treated as separators.
  return (cp >= 0x2000 && cp <= 0x206F)   // general punctuation (en/em dash…)
      || (cp >= 0x3000 && cp <= 0x303F)   // CJK symbols & punctuation
      || (cp >= 0xFF00 && cp <= 0xFF0F)   // fullwidth punctuation (part)
      || (cp >= 0xFE30 && cp <= 0xFE4F)   // CJK compat forms
      || cp == 0x00A0 || cp == 0x00B7     // nbsp, middle dot
      || (cp >= 0x00A1 && cp <= 0x00BF);  // latin-1 punctuation/symbols
}

// Decode one UTF-8 codepoint at s[i]; advances i. Invalid bytes decode as
// themselves (latin-1 style) so tokenization never fails.
inline uint32_t decode_utf8(const uint8_t* s, int64_t len, int64_t& i) {
  uint8_t b = s[i];
  if (b < 0x80) { i += 1; return b; }
  if ((b >> 5) == 0x6 && i + 1 < len) {
    uint32_t cp = ((b & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((b >> 4) == 0xE && i + 2 < len) {
    uint32_t cp = ((b & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((b >> 3) == 0x1E && i + 3 < len) {
    uint32_t cp = ((b & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1; return b;
}

// Append the UTF-8 encoding of cp to out, lowercasing ASCII.
inline void append_cp(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    char c = static_cast<char>(cp);
    if (c >= 'A' && c <= 'Z') c += 32;
    out.push_back(c);
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

inline bool is_word_cp(uint32_t cp) {
  if (cp < 0x80) {
    return (cp >= 'a' && cp <= 'z') || (cp >= 'A' && cp <= 'Z') ||
           (cp >= '0' && cp <= '9') || cp == '_';
  }
  return !is_unicode_punct(cp);
}

inline bool is_space_cp(uint32_t cp) {
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == '\f' ||
         cp == '\v' || cp == 0x85 || cp == 0xA0 || (cp >= 0x2000 && cp <= 0x200A) ||
         cp == 0x2028 || cp == 0x2029 || cp == 0x202F || cp == 0x205F || cp == 0x3000;
}

// Lowercase: ASCII + Latin-1 uppercase letters (matches str.lower() for the
// Latin-1 range; other scripts pass through — only affects which hash row a
// rare token maps to).
inline uint32_t lower_cp(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp >= 0xC0 && cp <= 0xDE && cp != 0xD7) return cp + 32;
  return cp;
}

// zlib-compatible CRC32 (reflected 0xEDB88320).
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int j = 0; j < 8; ++j) c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
  }
};
static const Crc32Table kCrc;

inline uint32_t crc32_bytes(const char* data, size_t len) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i) {
    c = kCrc.t[(c ^ static_cast<uint8_t>(data[i])) & 0xFF] ^ (c >> 8);
  }
  return c ^ 0xFFFFFFFFu;
}

// Tokenizer matching Python's `re.findall(r"\w+|[^\w\s]", text.lower())`:
// word-char runs, plus single non-word non-space codepoints.
struct HashToken {
  std::vector<uint32_t> cps;  // lowercased codepoints
};

}  // namespace

extern "C" {

// Featurize text for the hash encoder (models/encoder.py:HashEncoder):
// per token emit crc32 hashes of the token and of the character trigrams of
// "#token#" (when the token has >2 codepoints), with sign from crc bit 31.
// Outputs: ids [cap] int32, signs [cap] float, bounds [max_tokens+1] int64
// (feature range per token).  Returns the token count (bounds[n] = total
// features); negative return = cap exceeded.
int32_t rlt_hash_featurize(const char* text, int64_t len, int32_t max_tokens,
                           uint32_t mask, int32_t* ids, float* signs,
                           int64_t* bounds, int64_t cap) {
  const uint8_t* s = reinterpret_cast<const uint8_t*>(text);
  int64_t i = 0;
  int32_t n_tokens = 0;
  int64_t n_feats = 0;
  std::vector<uint32_t> cps;
  std::string utf8;
  bounds[0] = 0;

  auto emit_feature = [&](const std::string& bytes) -> bool {
    if (n_feats >= cap) return false;
    uint32_t h = crc32_bytes(bytes.data(), bytes.size());
    ids[n_feats] = static_cast<int32_t>(h & mask);
    signs[n_feats] = ((h >> 31) & 1) ? 1.0f : -1.0f;
    ++n_feats;
    return true;
  };
  auto encode = [](std::string& out, const uint32_t* cps, size_t n) {
    out.clear();
    for (size_t k = 0; k < n; ++k) append_cp(out, cps[k]);
  };
  auto emit_token = [&]() -> bool {
    if (cps.empty()) return true;
    if (n_tokens >= max_tokens) { cps.clear(); return true; }
    encode(utf8, cps.data(), cps.size());
    if (!emit_feature(utf8)) return false;
    if (cps.size() > 2) {
      std::vector<uint32_t> padded;
      padded.reserve(cps.size() + 2);
      padded.push_back('#');
      padded.insert(padded.end(), cps.begin(), cps.end());
      padded.push_back('#');
      for (size_t k = 0; k + 2 < padded.size(); ++k) {
        encode(utf8, padded.data() + k, 3);
        if (!emit_feature(utf8)) return false;
      }
    }
    ++n_tokens;
    bounds[n_tokens] = n_feats;
    cps.clear();
    return true;
  };

  while (i < len) {
    uint32_t cp = lower_cp(decode_utf8(s, len, i));
    if (is_word_cp(cp)) {
      cps.push_back(cp);
    } else {
      if (!emit_token()) return -1;
      if (!is_space_cp(cp) && n_tokens < max_tokens) {
        // Single punctuation token ([^\w\s] branch of the regex).
        cps.push_back(cp);
        if (!emit_token()) return -1;
      }
    }
    if (n_tokens >= max_tokens) break;
  }
  if (!emit_token()) return -1;
  return n_tokens;
}

// Fused hash embedding (models/encoder.py:HashEncoder CPU fast path):
// tokenize, hash features, and accumulate signed table rows directly into
// per-token output rows — no [features, dim] intermediate.  ``table`` is the
// fp32 feature table [mask+1, dim]; ``out`` is [max_tokens, dim] (caller
// zero-fills).  Rows are L2-normalized.  Returns the token count.
int32_t rlt_hash_embed(const char* text, int64_t len, int32_t max_tokens,
                       uint32_t mask, const float* table, int32_t dim,
                       float* out) {
  const uint8_t* s = reinterpret_cast<const uint8_t*>(text);
  int64_t i = 0;
  int32_t n_tokens = 0;
  std::vector<uint32_t> cps;
  std::string utf8;

  auto accumulate = [&](const std::string& bytes, float* row) {
    uint32_t h = crc32_bytes(bytes.data(), bytes.size());
    const float sign = ((h >> 31) & 1) ? 1.0f : -1.0f;
    const float* src = table + static_cast<int64_t>(h & mask) * dim;
    for (int32_t k = 0; k < dim; ++k) row[k] += sign * src[k];
  };
  auto encode = [](std::string& o, const uint32_t* cps, size_t n) {
    o.clear();
    for (size_t k = 0; k < n; ++k) append_cp(o, cps[k]);
  };
  auto emit_token = [&]() {
    if (cps.empty()) return;
    if (n_tokens >= max_tokens) { cps.clear(); return; }
    float* row = out + static_cast<int64_t>(n_tokens) * dim;
    encode(utf8, cps.data(), cps.size());
    accumulate(utf8, row);
    if (cps.size() > 2) {
      std::vector<uint32_t> padded;
      padded.reserve(cps.size() + 2);
      padded.push_back('#');
      padded.insert(padded.end(), cps.begin(), cps.end());
      padded.push_back('#');
      for (size_t k = 0; k + 2 < padded.size(); ++k) {
        encode(utf8, padded.data() + k, 3);
        accumulate(utf8, row);
      }
    }
    double norm = 0.0;
    for (int32_t k = 0; k < dim; ++k) norm += static_cast<double>(row[k]) * row[k];
    const float inv = 1.0f / static_cast<float>(std::max(std::sqrt(norm), 1e-6));
    for (int32_t k = 0; k < dim; ++k) row[k] *= inv;
    ++n_tokens;
    cps.clear();
  };

  while (i < len && n_tokens < max_tokens) {
    uint32_t cp = lower_cp(decode_utf8(s, len, i));
    if (is_word_cp(cp)) {
      cps.push_back(cp);
    } else {
      emit_token();
      if (!is_space_cp(cp) && n_tokens < max_tokens) {
        cps.push_back(cp);
        emit_token();
      }
    }
  }
  emit_token();
  return n_tokens;
}

// Sentence-boundary DP (sentences.py:_solve_boundaries fast path): pick
// boundary positions maximizing sum(probas[i] - threshold) subject to every
// segment having length in [min_len, window].  Monotone-deque sliding-window
// maximum, O(n).  Returns the number of boundaries written to `out`
// (capacity n), 0 for "no boundaries", or -1 for "infeasible" (the Python
// caller maps -1 to None).
int64_t rlt_solve_boundaries(const float* probas, int64_t n, int64_t min_len,
                             int64_t window /* <= 0 -> unbounded */,
                             float threshold, int64_t* out) {
  if (n <= 0) return 0;
  const bool bounded = window > 0;
  const int64_t win = bounded ? window : n + 1;
  const int64_t lo = min_len - 1;
  const int64_t hi = n - min_len - 1;
  const double NEG = -1e300;
  // Too short for any split: no-split only if it respects the window;
  // otherwise infeasible (-1) — matches the Python oracle.
  if (hi < lo) return (!bounded || n <= window) ? 0 : -1;
  std::vector<double> dp(static_cast<size_t>(n), NEG);
  std::vector<int64_t> back(static_cast<size_t>(n), -1);
  std::vector<int64_t> dq(static_cast<size_t>(n));  // deque as ring-ish array
  int64_t dq_head = 0, dq_tail = 0;                 // [head, tail)
  for (int64_t i = lo; i <= hi; ++i) {
    const int64_t j = i - min_len;
    if (j >= lo && dp[j] > NEG) {
      while (dq_tail > dq_head && dp[dq[dq_tail - 1]] <= dp[j]) --dq_tail;
      dq[dq_tail++] = j;
    }
    while (dq_tail > dq_head && dq[dq_head] < i - win) ++dq_head;
    const double score = static_cast<double>(probas[i]) - threshold;
    if (i + 1 <= win) dp[i] = score;
    if (dq_tail > dq_head) {
      const double cand = dp[dq[dq_head]] + score;
      if (cand > dp[i]) {
        dp[i] = cand;
        back[i] = dq[dq_head];
      }
    }
  }
  const int64_t tail_lo = bounded ? std::max(lo, n - win - 1) : lo;
  const bool no_split_ok = !bounded || n <= win;
  double best = no_split_ok ? 0.0 : NEG;
  int64_t best_i = -1;
  for (int64_t i = tail_lo; i <= hi; ++i) {
    if (dp[i] > best) { best = dp[i]; best_i = i; }
  }
  if (best_i == -1) return no_split_ok ? 0 : -1;
  int64_t count = 0;
  for (int64_t pos = best_i; pos >= 0; pos = back[pos]) out[count++] = pos;
  std::reverse(out, out + count);
  return count;
}

// Chunklet-partition DP (chunklets.py:split_chunklets default-cost fast
// path): minimize sum over chunklets of
//   (1 - p[first]) + sum(p[rest]) + (s - 3)^2 / sqrt(s) / 2
// where s = statements in the chunklet, subject to each chunklet fitting in
// max_size characters (a single oversize sentence stands alone).  O(n*w)
// exact DP over prefix sums.  Writes interior cut indices to `cuts` and
// returns their count.
int64_t rlt_split_chunklets(const double* probas, const double* pref_proba,
                            const double* pref_stmt, const int64_t* pref_len,
                            int64_t n, int64_t max_size, int64_t* cuts) {
  if (n <= 0) return 0;
  std::vector<double> dp(static_cast<size_t>(n) + 1, 1e300);
  std::vector<int64_t> back(static_cast<size_t>(n) + 1, -1);
  dp[0] = 0.0;
  int64_t lo = 0;
  for (int64_t i = 1; i <= n; ++i) {
    while (lo < i && pref_len[i] - pref_len[lo] > max_size) ++lo;
    int64_t j_begin = lo, j_end = i;  // predecessors [j_begin, j_end)
    if (j_begin >= j_end) j_begin = i - 1;  // oversize sentence stands alone
    double best = 1e300;
    int64_t best_j = -1;
    for (int64_t j = j_begin; j < j_end; ++j) {
      const double s = pref_stmt[i] - pref_stmt[j];
      const double s_safe = std::max(s, 1e-6);
      const double cost = dp[j] + (1.0 - probas[j]) +
                          (pref_proba[i] - pref_proba[j + 1]) +
                          (s - 3.0) * (s - 3.0) / std::sqrt(s_safe) / 2.0;
      if (cost < best) { best = cost; best_j = j; }
    }
    dp[i] = best;
    back[i] = best_j;
  }
  int64_t count = 0;
  for (int64_t i = back[n]; i > 0; i = back[i]) cuts[count++] = i;
  std::reverse(cuts, cuts + count);
  return count;
}

// Token count only (models/encoder.py:count_tokens fast path).
int32_t rlt_count_tokens(const char* text, int64_t len) {
  const uint8_t* s = reinterpret_cast<const uint8_t*>(text);
  int64_t i = 0;
  int32_t n = 0;
  bool in_word = false;
  while (i < len) {
    uint32_t cp = decode_utf8(s, len, i);
    if (is_word_cp(cp)) {
      if (!in_word) { ++n; in_word = true; }
    } else {
      in_word = false;
      if (!is_space_cp(cp)) ++n;
    }
  }
  return n;
}

void* rlt_builder_new() { return new Builder(); }

void rlt_builder_free(void* h) { delete static_cast<Builder*>(h); }

// Tokenize `text[0:len]`, accumulate postings for the next chunk ordinal.
// Returns the chunk ordinal.
int32_t rlt_builder_add_chunk(void* h, const char* text, int64_t len) {
  Builder& b = *static_cast<Builder*>(h);
  const uint8_t* s = reinterpret_cast<const uint8_t*>(text);
  const int32_t ordinal = static_cast<int32_t>(b.doc_len.size());
  b.chunk_tf.clear();
  std::string token;
  int32_t n_tokens = 0;
  int64_t i = 0;
  auto flush = [&]() {
    if (token.empty()) return;
    auto [it, inserted] = b.dict.try_emplace(token, static_cast<int32_t>(b.terms.size()));
    if (inserted) {
      b.terms.push_back(token);
      b.postings.emplace_back();
    }
    b.chunk_tf[it->second] += 1;
    n_tokens += 1;
    token.clear();
  };
  while (i < len) {
    uint32_t cp = decode_utf8(s, len, i);
    if (is_word_cp(cp)) {
      append_cp(token, cp);
    } else {
      flush();
    }
  }
  flush();
  for (const auto& [tid, tf] : b.chunk_tf) {
    b.postings[tid].emplace_back(ordinal, tf);
  }
  b.doc_len.push_back(n_tokens);
  return ordinal;
}

int32_t rlt_builder_num_terms(void* h) {
  return static_cast<int32_t>(static_cast<Builder*>(h)->terms.size());
}

int32_t rlt_builder_num_chunks(void* h) {
  return static_cast<int32_t>(static_cast<Builder*>(h)->doc_len.size());
}

int64_t rlt_builder_num_postings(void* h) {
  int64_t total = 0;
  for (const auto& p : static_cast<Builder*>(h)->postings) total += p.size();
  return total;
}

int64_t rlt_builder_dict_bytes(void* h) {
  int64_t total = 0;
  for (const auto& t : static_cast<Builder*>(h)->terms) total += t.size();
  return total;
}

// Export CSR postings + dictionary into caller-allocated buffers:
//   offsets      [num_terms + 1] int64   postings range per term
//   chunks       [num_postings]  int32   chunk ordinals (ascending per term)
//   tf           [num_postings]  int32   term frequencies
//   doc_len      [num_chunks]    int32
//   term_offsets [num_terms + 1] int64   byte range per term in term_bytes
//   term_bytes   [dict_bytes]    char
void rlt_builder_export(void* h, int64_t* offsets, int32_t* chunks, int32_t* tf,
                        int32_t* doc_len, int64_t* term_offsets, char* term_bytes) {
  Builder& b = *static_cast<Builder*>(h);
  int64_t pos = 0;
  offsets[0] = 0;
  for (size_t t = 0; t < b.postings.size(); ++t) {
    for (const auto& [chunk, freq] : b.postings[t]) {
      chunks[pos] = chunk;
      tf[pos] = freq;
      ++pos;
    }
    offsets[t + 1] = pos;
  }
  std::memcpy(doc_len, b.doc_len.data(), b.doc_len.size() * sizeof(int32_t));
  int64_t byte_pos = 0;
  term_offsets[0] = 0;
  for (size_t t = 0; t < b.terms.size(); ++t) {
    std::memcpy(term_bytes + byte_pos, b.terms[t].data(), b.terms[t].size());
    byte_pos += static_cast<int64_t>(b.terms[t].size());
    term_offsets[t + 1] = byte_pos;
  }
}

// Look up a term; returns its id or -1.
int32_t rlt_builder_lookup(void* h, const char* term, int64_t len) {
  Builder& b = *static_cast<Builder*>(h);
  auto it = b.dict.find(std::string(term, static_cast<size_t>(len)));
  return it == b.dict.end() ? -1 : it->second;
}

// Tokenize into term ids (for query-side parity with the indexed corpus).
// Unknown terms are skipped. Returns the number of ids written (<= cap).
int32_t rlt_builder_tokenize_lookup(void* h, const char* text, int64_t len,
                                    int32_t* out_ids, int32_t cap) {
  Builder& b = *static_cast<Builder*>(h);
  const uint8_t* s = reinterpret_cast<const uint8_t*>(text);
  std::string token;
  int32_t n = 0;
  int64_t i = 0;
  auto flush = [&]() {
    if (token.empty()) return;
    auto it = b.dict.find(token);
    if (it != b.dict.end() && n < cap) out_ids[n++] = it->second;
    token.clear();
  };
  while (i < len && n < cap) {
    uint32_t cp = decode_utf8(s, len, i);
    if (is_word_cp(cp)) append_cp(token, cp);
    else flush();
  }
  flush();
  return n;
}

// --- Serialization ---------------------------------------------------------

static const uint64_t kMagic = 0x52414C54504F5354ull;  // "RALTPOST"

// Serialized size in bytes (for caller allocation).
int64_t rlt_builder_save_size(void* h) {
  Builder& b = *static_cast<Builder*>(h);
  int64_t n_terms = static_cast<int64_t>(b.terms.size());
  int64_t n_post = rlt_builder_num_postings(h);
  int64_t dict_bytes = rlt_builder_dict_bytes(h);
  return 8 * 4                              // magic, n_terms, n_chunks, n_postings
       + 8                                  // dict_bytes
       + (n_terms + 1) * 8                  // offsets
       + n_post * 4 * 2                     // chunks + tf
       + static_cast<int64_t>(b.doc_len.size()) * 4
       + (n_terms + 1) * 8                  // term_offsets
       + dict_bytes;
}

void rlt_builder_save(void* h, char* out) {
  Builder& b = *static_cast<Builder*>(h);
  int64_t n_terms = static_cast<int64_t>(b.terms.size());
  int64_t n_chunks = static_cast<int64_t>(b.doc_len.size());
  int64_t n_post = rlt_builder_num_postings(h);
  int64_t dict_bytes = rlt_builder_dict_bytes(h);
  char* p = out;
  auto put = [&p](const void* src, size_t n) { std::memcpy(p, src, n); p += n; };
  put(&kMagic, 8); put(&n_terms, 8); put(&n_chunks, 8); put(&n_post, 8);
  put(&dict_bytes, 8);
  std::vector<int64_t> offsets(n_terms + 1);
  std::vector<int32_t> chunks(n_post), tf(n_post);
  std::vector<int64_t> term_offsets(n_terms + 1);
  std::vector<char> term_bytes(dict_bytes);
  std::vector<int32_t> doc_len(n_chunks);
  rlt_builder_export(h, offsets.data(), chunks.data(), tf.data(), doc_len.data(),
                     term_offsets.data(), term_bytes.data());
  put(offsets.data(), offsets.size() * 8);
  put(chunks.data(), chunks.size() * 4);
  put(tf.data(), tf.size() * 4);
  put(doc_len.data(), doc_len.size() * 4);
  put(term_offsets.data(), term_offsets.size() * 8);
  put(term_bytes.data(), term_bytes.size());
}

// Rebuild a Builder from a serialized blob; returns handle or null.
void* rlt_builder_load(const char* data, int64_t len) {
  // Every count and offset read from the blob is validated against `len`
  // before use: a truncated or corrupt blob must yield nullptr (the Python
  // side raises "corrupt postings blob"), never an out-of-bounds read, a
  // negative-size vector exception escaping extern "C", or a huge alloc.
  if (len < 40) return nullptr;
  const char* p = data;
  auto get = [&p](void* dst, size_t n) { std::memcpy(dst, p, n); p += n; };
  uint64_t magic; int64_t n_terms, n_chunks, n_post, dict_bytes;
  get(&magic, 8);
  if (magic != kMagic) return nullptr;
  get(&n_terms, 8); get(&n_chunks, 8); get(&n_post, 8); get(&dict_bytes, 8);
  if (n_terms < 0 || n_chunks < 0 || n_post < 0 || dict_bytes < 0) return nullptr;
  // Guard the size arithmetic itself against overflow before computing it.
  const int64_t kMax = len;  // every section must fit inside the blob
  if (n_terms > kMax / 8 || n_post > kMax / 4 || n_chunks > kMax / 4 ||
      dict_bytes > kMax) {
    return nullptr;
  }
  const int64_t expected = 40 + 2 * (n_terms + 1) * 8 + 2 * n_post * 4 +
                           n_chunks * 4 + dict_bytes;
  if (expected != len) return nullptr;
  std::vector<int64_t> offsets(n_terms + 1);
  get(offsets.data(), offsets.size() * 8);
  std::vector<int32_t> chunks(n_post), tf(n_post);
  get(chunks.data(), chunks.size() * 4);
  get(tf.data(), tf.size() * 4);
  std::vector<int32_t> doc_len(n_chunks);
  get(doc_len.data(), n_chunks * 4);
  std::vector<int64_t> term_offsets(n_terms + 1);
  get(term_offsets.data(), term_offsets.size() * 8);
  // Posting offsets: monotone, starting at 0, ending at n_post.
  if (offsets[0] != 0 || offsets[n_terms] != n_post) return nullptr;
  for (int64_t t = 0; t < n_terms; ++t) {
    if (offsets[t + 1] < offsets[t]) return nullptr;
  }
  // Term-string offsets: monotone and within the dictionary section.
  if (term_offsets[0] != 0 || term_offsets[n_terms] != dict_bytes) return nullptr;
  for (int64_t t = 0; t < n_terms; ++t) {
    if (term_offsets[t + 1] < term_offsets[t]) return nullptr;
  }
  Builder* b = new Builder();
  b->doc_len = std::move(doc_len);
  b->terms.resize(n_terms);
  b->postings.resize(n_terms);
  for (int64_t t = 0; t < n_terms; ++t) {
    b->terms[t].assign(p + term_offsets[t], p + term_offsets[t + 1]);
    b->dict.emplace(b->terms[t], static_cast<int32_t>(t));
    b->postings[t].reserve(offsets[t + 1] - offsets[t]);
    for (int64_t i = offsets[t]; i < offsets[t + 1]; ++i) {
      b->postings[t].emplace_back(chunks[i], tf[i]);
    }
  }
  return b;
}

}  // extern "C"

// The hash encoder's Gaussian table (raglite_tpu_torch/models/hash_table.py,
// which holds the same arithmetic in numpy and says where each step comes
// from): jax.random.normal(PRNGKey(seed), (rows, dim), float32) bit for bit.
// threefry-2x32 bits of each flat index, a uniform on (nextafter(-1, 0), 1),
// then sqrt(2) * erf_inv(u) with XLA's CPU polynomials for erf_inv, log1p and
// log, fused multiply-adds (std::fma, rounded once) exactly where XLA fuses
// them and nowhere else (ISO C++ mode: no contraction by the compiler).
namespace {

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint64_t index) {
  static const int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = static_cast<uint32_t>(index >> 32) + ks[0];
  uint32_t x1 = static_cast<uint32_t>(index) + ks[1];
  for (int i = 0; i < 5; ++i) {
    for (int r : kRot[i % 2]) {
      x0 += x1;
      x1 = rotl32(x1, r) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

inline float bits_float(uint32_t b) { float f; std::memcpy(&f, &b, 4); return f; }
inline uint32_t float_bits(float f) { uint32_t b; std::memcpy(&b, &f, 4); return b; }

float xla_log(float x) {
  const float p[9] = {7.0376836292e-2f, -1.1514610310e-1f, 1.1676998740e-1f,
                      -1.2420140846e-1f, 1.4249322787e-1f, -1.6668057665e-1f,
                      2.0000714765e-1f, -2.4999993993e-1f, 3.3333331174e-1f};
  const uint32_t bits = float_bits(std::max(x, bits_float(0x00800000u)));
  float e = 1.0f + static_cast<float>(static_cast<int32_t>(bits >> 23) - 0x7f);
  const float m = bits_float((bits & ~0x7f800000u) | float_bits(0.5f));
  const bool low = m < 0.707106781186547524f;
  e -= low ? 1.0f : 0.0f;
  const float t = (m - 1.0f) + (low ? m : 0.0f);
  const float x2 = t * t;
  const float x3 = x2 * t;
  float y = std::fma(std::fma(t, p[0], p[1]), t, p[2]);
  const float y1 = std::fma(std::fma(t, p[3], p[4]), t, p[5]);
  const float y2 = std::fma(std::fma(t, p[6], p[7]), t, p[8]);
  y = std::fma(y, x3, y1);
  y = std::fma(y, x3, y2);
  y = std::fma(y, x3, -2.12194440e-4f * e);
  return ((t - 0.5f * x2) + y) + 0.693359375f * e;
}

float xla_log1p(float x) {
  if (!(std::fabs(x) < 0.41421356237309504880f)) return xla_log(x + 1.0f);
  static const double kNum[7] = {
      4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
      2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
      2.0039553499201281259648e1};
  static const double kDen[7] = {
      1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
      3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1};
  float num = 0.0f, den = 0.0f;
  for (int k = 0; k < 7; ++k) {
    num = std::fma(num, x, static_cast<float>(kNum[k]));
    den = std::fma(den, x, static_cast<float>(kDen[k]));
  }
  const float x2 = x * x;
  const float small = (x * x2) * (num / den);
  return x + std::fma(-0.5f, x2, small);
}

float xla_erf_inv(float x) {
  static const float kLt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                                -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                                -0.00417768164f, 0.246640727f, 1.50140941f};
  static const float kGe5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                                -0.00367342844f, 0.00573950773f, -0.0076224613f,
                                0.00943887047f, 1.00167406f, 2.83297682f};
  float w = -xla_log1p(x * -x);
  const bool lt = w < 5.0f;
  const float* c = lt ? kLt5 : kGe5;
  w = lt ? w - 2.5f : std::sqrt(w) - 3.0f;
  float p = c[0];
  for (int k = 1; k < 9; ++k) p = std::fma(p, w, c[k]);
  return p * x;
}

}  // namespace

extern "C" {

// Fills out[0 .. rows * dim) with the table; seed is JAX's PRNGKey seed.
void rlt_normal_table(int64_t seed, int64_t rows, int64_t dim, float* out) {
  const uint32_t k0 = static_cast<uint32_t>(static_cast<uint64_t>(seed) >> 32);
  const uint32_t k1 = static_cast<uint32_t>(seed);
  const int64_t n = rows * dim;
  const float lo = std::nextafter(-1.0f, 0.0f);
  const float span = 1.0f - lo;  // 2.0f in f32, as XLA computes it
  const float sqrt2 = static_cast<float>(std::sqrt(2.0));
  auto work = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const uint32_t b = threefry_bits(k0, k1, static_cast<uint64_t>(i));
      const float f = bits_float((b >> 9) | float_bits(1.0f)) - 1.0f;
      const float u = std::max(lo, f * span + lo);
      out[i] = sqrt2 * xla_erf_inv(u);
    }
  };
  const int64_t threads = std::max<int64_t>(1, std::min<int64_t>(
      std::thread::hardware_concurrency(), n / (1 << 20)));
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < threads; ++t) {
    pool.emplace_back(work, n * t / threads, n * (t + 1) / threads);
  }
  work(0, n / threads);
  for (auto& th : pool) th.join();
}

}  // extern "C"
