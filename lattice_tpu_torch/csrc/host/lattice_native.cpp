// lattice_native: C++ host-side kernels for the lattice-tpu framework.
//
// Replaces the native capabilities the reference pulled in through
// dependencies (SURVEY §2.3):
//   - SHA-256 content hashing (the incremental-indexing key; reference
//     hashes every scanned file in Python, `parsing/scanner.py:43`)
//   - BPE token counting for chunk budgets (reference uses the tiktoken
//     Rust wheel, `embeddings/chunker.py:50`; its vocab download needs
//     network, so this engine loads any local merges.txt)
//
// Exposed as a plain C ABI consumed via ctypes (pybind11 is not available
// in this environment).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o liblattice_native.so lattice_native.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4), dependency-free implementation.
// ---------------------------------------------------------------------------

namespace sha256 {

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

struct State {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint64_t total = 0;
  uint8_t buf[64];
  size_t buf_len = 0;

  void process(const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++) {
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    }
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* data, size_t len) {
    total += len;
    while (len > 0) {
      size_t take = 64 - buf_len;
      if (take > len) take = len;
      memcpy(buf + buf_len, data, take);
      buf_len += take;
      data += take;
      len -= take;
      if (buf_len == 64) {
        process(buf);
        buf_len = 0;
      }
    }
  }

  void finish(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buf_len != 56) update(&zero, 1);
    uint8_t len_be[8];
    for (int i = 0; i < 8; i++) len_be[i] = uint8_t(bits >> (56 - 8 * i));
    // write length without re-counting it in `total`
    memcpy(buf + 56, len_be, 8);
    process(buf);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

}  // namespace sha256

extern "C" {

// Hash a file; writes 64 hex chars + NUL into out_hex (>= 65 bytes).
// Returns 0 on success, -1 on IO error.
int lattice_sha256_file(const char* path, char* out_hex) {
  std::ifstream in(path, std::ios::binary);
  if (!in.is_open()) return -1;
  sha256::State state;
  std::vector<char> buf(1 << 20);
  while (in.good()) {
    in.read(buf.data(), buf.size());
    std::streamsize got = in.gcount();
    if (got > 0)
      state.update(reinterpret_cast<const uint8_t*>(buf.data()), size_t(got));
  }
  if (in.bad()) return -1;
  uint8_t digest[32];
  state.finish(digest);
  static const char* hex = "0123456789abcdef";
  for (int i = 0; i < 32; i++) {
    out_hex[2 * i] = hex[digest[i] >> 4];
    out_hex[2 * i + 1] = hex[digest[i] & 0xf];
  }
  out_hex[64] = '\0';
  return 0;
}

// Hash an in-memory buffer.
int lattice_sha256_bytes(const uint8_t* data, int64_t len, char* out_hex) {
  sha256::State state;
  state.update(data, size_t(len));
  uint8_t digest[32];
  state.finish(digest);
  static const char* hex = "0123456789abcdef";
  for (int i = 0; i < 32; i++) {
    out_hex[2 * i] = hex[digest[i] >> 4];
    out_hex[2 * i + 1] = hex[digest[i] & 0xf];
  }
  out_hex[64] = '\0';
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BPE token counter.
//
// Greedy lowest-rank merges over pre-tokenized words (GPT-2 family
// semantics). The merges file is the standard `merges.txt`: one
// space-separated pair per line, rank = line order.
// ---------------------------------------------------------------------------

namespace bpe {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1315423911u ^ h(p.second);
  }
};

struct Engine {
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;

  bool load(const char* merges_path) {
    std::ifstream in(merges_path);
    if (!in.is_open()) return false;
    std::string line;
    int rank = 0;
    while (std::getline(in, line)) {
      if (line.empty() || line[0] == '#') continue;
      size_t sp = line.find(' ');
      if (sp == std::string::npos) continue;
      ranks.emplace(std::make_pair(line.substr(0, sp), line.substr(sp + 1)),
                    rank++);
    }
    return !ranks.empty();
  }

  // Number of BPE pieces for one pre-tokenized word.
  int count_word(const std::string& word) const {
    if (word.size() <= 1) return int(word.size());
    std::vector<std::string> pieces;
    pieces.reserve(word.size());
    for (char c : word) pieces.emplace_back(1, c);
    while (pieces.size() > 1) {
      int best_rank = INT32_MAX;
      size_t best_i = SIZE_MAX;
      for (size_t i = 0; i + 1 < pieces.size(); i++) {
        auto it = ranks.find({pieces[i], pieces[i + 1]});
        if (it != ranks.end() && it->second < best_rank) {
          best_rank = it->second;
          best_i = i;
        }
      }
      if (best_i == SIZE_MAX) break;
      pieces[best_i] += pieces[best_i + 1];
      pieces.erase(pieces.begin() + best_i + 1);
    }
    return int(pieces.size());
  }
};

static inline bool is_alpha(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || c >= 0x80;
}
static inline bool is_digit(unsigned char c) { return c >= '0' && c <= '9'; }
static inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f';
}

// GPT-2-style pre-tokenization: leading space folds into the word.
static void pre_tokenize(const char* text, int64_t len,
                         std::vector<std::string>& out) {
  int64_t i = 0;
  while (i < len) {
    unsigned char c = text[i];
    std::string tok;
    if (is_space(c)) {
      if (c == ' ' && i + 1 < len &&
          (is_alpha(text[i + 1]) || is_digit(text[i + 1]))) {
        tok.push_back(' ');
        i++;
        c = text[i];
      } else {
        // whitespace run
        while (i < len && is_space((unsigned char)text[i]) &&
               !(text[i] == ' ' && i + 1 < len &&
                 (is_alpha(text[i + 1]) || is_digit(text[i + 1])))) {
          tok.push_back(text[i]);
          i++;
        }
        out.push_back(tok);
        continue;
      }
    }
    if (is_alpha(c)) {
      while (i < len && is_alpha((unsigned char)text[i])) tok.push_back(text[i++]);
    } else if (is_digit(c)) {
      while (i < len && is_digit((unsigned char)text[i])) tok.push_back(text[i++]);
    } else {
      while (i < len && !is_alpha((unsigned char)text[i]) &&
             !is_digit((unsigned char)text[i]) &&
             !is_space((unsigned char)text[i]))
        tok.push_back(text[i++]);
    }
    out.push_back(tok);
  }
}

}  // namespace bpe

extern "C" {

void* lattice_bpe_create(const char* merges_path) {
  auto* engine = new bpe::Engine();
  if (!engine->load(merges_path)) {
    delete engine;
    return nullptr;
  }
  return engine;
}

void lattice_bpe_destroy(void* handle) {
  delete static_cast<bpe::Engine*>(handle);
}

// Token count for a UTF-8 buffer. Whitespace runs count 1 per newline
// (matching the Python approx counter's budget semantics).
int64_t lattice_bpe_count(void* handle, const char* text, int64_t len) {
  auto* engine = static_cast<bpe::Engine*>(handle);
  std::vector<std::string> words;
  bpe::pre_tokenize(text, len, words);
  int64_t total = 0;
  for (const auto& w : words) {
    if (w.empty()) continue;
    if (bpe::is_space((unsigned char)w[0])) {
      if (w != " ") {
        int64_t newlines = 0;
        for (char c : w)
          if (c == '\n') newlines++;
        total += newlines ? newlines : (w.size() > 1 ? 1 : 0);
      }
      continue;
    }
    // GPT-2 space marker: leading space becomes 'Ġ' in merges vocabularies.
    std::string word = w;
    if (word[0] == ' ') word = std::string("\xC4\xA0") + word.substr(1);
    total += engine->count_word(word);
  }
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Bounded k-hop BFS over CSR (graph serving host path).
//
// Replaces the per-traversal Cypher round-trip of the reference
// (src/lattice/query/graph_reasoning/queries.py:2-50 ORDER BY depth
// LIMIT n). The NumPy frontier walk (index/graph_store.py:_host_bfs)
// costs ~4 ms/query at 1M nodes / 10M edges — dominated by small-array
// NumPy call overhead, not memory traffic, because serving traversals
// stop at limit=50 results. This C++ walk with an epoch-marked visited
// array runs the same bounded traversal in microseconds and batches
// across queries with OpenMP on multi-core hosts.
//
// Semantics mirror _host_bfs exactly: seeds (even dead ones) expand,
// dead nodes relay but never surface, results are (depth, id)
// lexicographic, and expansion stops at the first depth level where the
// cumulative alive count reaches `limit`.
// ---------------------------------------------------------------------------

#include <algorithm>

namespace bfs {

static int64_t khop_one(const int64_t* indptr, const int32_t* indices,
                        const uint8_t* alive, int64_t n,
                        const int32_t* seeds, int64_t n_seeds,
                        int32_t hops, int64_t limit,
                        int32_t* mark, int32_t epoch,
                        std::vector<int32_t>& frontier,
                        std::vector<int32_t>& next,
                        int32_t* out_ids, int32_t* out_depths,
                        int64_t out_cap) {
  frontier.clear();
  for (int64_t i = 0; i < n_seeds; i++) {
    int32_t s = seeds[i];
    if (s < 0 || s >= n) continue;
    if (mark[s] != epoch) {
      mark[s] = epoch;
      frontier.push_back(s);
    }
  }
  int64_t written = 0, alive_cnt = 0;
  for (int32_t hop = 1; hop <= hops && !frontier.empty(); hop++) {
    next.clear();
    for (int32_t u : frontier) {
      for (int64_t e = indptr[u]; e < indptr[u + 1]; e++) {
        int32_t v = indices[e];
        if (mark[v] != epoch) {
          mark[v] = epoch;
          next.push_back(v);
        }
      }
    }
    if (next.empty()) break;
    std::sort(next.begin(), next.end());
    for (int32_t v : next) {
      if (alive[v]) {
        alive_cnt++;
        if (written < out_cap) {
          out_ids[written] = v;
          out_depths[written] = hop;
          written++;
        }
      }
    }
    if (limit > 0 && alive_cnt >= limit) break;
    frontier.swap(next);
  }
  return written;
}

}  // namespace bfs

extern "C" {

// Single traversal. `mark` is caller-owned scratch [n] (epoch-tagged so
// it is never re-zeroed between queries); returns alive nodes written.
int64_t lattice_bfs_khop(const int64_t* indptr, const int32_t* indices,
                         const uint8_t* alive, int64_t n,
                         const int32_t* seeds, int64_t n_seeds,
                         int32_t hops, int64_t limit,
                         int32_t* mark, int32_t epoch,
                         int32_t* out_ids, int32_t* out_depths,
                         int64_t out_cap) {
  std::vector<int32_t> frontier, next;
  return bfs::khop_one(indptr, indices, alive, n, seeds, n_seeds, hops,
                       limit, mark, epoch, frontier, next, out_ids,
                       out_depths, out_cap);
}

// Q independent traversals; seeds are flattened with prefix offsets
// [Q+1]. Outputs are [Q, out_cap] row-major; out_counts[q] says how many
// entries of row q are valid. OpenMP splits queries across cores when
// compiled with -fopenmp (per-thread visited scratch).
int64_t lattice_bfs_khop_batch(const int64_t* indptr, const int32_t* indices,
                               const uint8_t* alive, int64_t n,
                               const int32_t* seeds,
                               const int64_t* seed_offsets, int64_t n_queries,
                               int32_t hops, int64_t limit,
                               int32_t* out_ids, int32_t* out_depths,
                               int64_t* out_counts, int64_t out_cap) {
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<int32_t> mark((size_t)n, -1);
    std::vector<int32_t> frontier, next;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
    for (int64_t q = 0; q < n_queries; q++) {
      out_counts[q] = bfs::khop_one(
          indptr, indices, alive, n, seeds + seed_offsets[q],
          seed_offsets[q + 1] - seed_offsets[q], hops, limit, mark.data(),
          (int32_t)q, frontier, next, out_ids + q * out_cap,
          out_depths + q * out_cap, out_cap);
    }
  }
  return 0;
}

}  // extern "C"
