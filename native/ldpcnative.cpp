// Native construction/IO kernels for ldpcsimulation_tpu.
//
// The reference implements its code tooling in C/C++ (MacKay's alist loader
// C_implementations/src/alist.cpp, Neal's generation utilities under
// SystemC/NGDBF/codes/PegReg/).  This library is the framework's native
// tier for the same roles where Python is too slow at scale:
//
//   * peg_construct: Progressive-Edge-Growth Tanner-graph construction
//     (Hu-Eleftheriou-Arnold).  Python PEG is fine to n~4000; DVB-S2-sized
//     codes (n = 64800) need this.
//   * alist_parse_dims / alist_parse_fill: two-pass alist tokenizer into
//     padded int32 slot arrays (binary and non-binary dialects).
//
// Build: g++ -O3 -shared -fPIC -o libldpcnative.so ldpcnative.cpp
// Exposed with a plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// xorshift64* — deterministic, seedable, dependency-free
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
  }
  // unbiased-enough range pick for candidate tie-breaks
  uint32_t below(uint32_t bound) { return (uint32_t)(next() % bound); }
};

}  // namespace

extern "C" {

// Progressive Edge Growth: fills out[n*dv] with the check index of each
// variable's edges (sorted ascending per variable).  Returns 0 on success.
int peg_construct(int32_t n, int32_t m, int32_t dv, uint64_t seed,
                  int32_t* out) {
  if (n <= 0 || m <= 0 || dv <= 0 || (int64_t)n * dv < m) return 1;
  Rng rng(seed * 0x9E3779B97F4A7C15ULL + 1);

  std::vector<std::vector<int32_t>> var_checks(n);
  std::vector<std::vector<int32_t>> check_vars(m);
  std::vector<int64_t> check_deg(m, 0);

  // scratch for BFS
  std::vector<int32_t> dist(m);
  std::vector<uint8_t> seen_var(n);
  std::vector<int32_t> frontier, next_frontier, cands;

  for (int32_t v = 0; v < n; ++v) {
    var_checks[v].reserve(dv);
    for (int32_t e = 0; e < dv; ++e) {
      cands.clear();
      if (e == 0) {
        // minimum-degree checks
        int64_t best = INT64_MAX;
        for (int32_t c = 0; c < m; ++c)
          if (check_deg[c] < best) best = check_deg[c];
        for (int32_t c = 0; c < m; ++c)
          if (check_deg[c] == best) cands.push_back(c);
      } else {
        // BFS over the current subgraph from v; saturation-aware
        std::fill(dist.begin(), dist.end(), -1);
        std::fill(seen_var.begin(), seen_var.end(), 0);
        seen_var[v] = 1;
        frontier.clear();
        int32_t reached = 0;
        for (int32_t c : var_checks[v]) {
          dist[c] = 0;
          frontier.push_back(c);
          ++reached;
        }
        int32_t depth = 0;
        while (!frontier.empty() && reached < m) {
          next_frontier.clear();
          for (int32_t c : frontier) {
            for (int32_t v2 : check_vars[c]) {
              if (!seen_var[v2]) {
                seen_var[v2] = 1;
                for (int32_t c2 : var_checks[v2]) {
                  if (dist[c2] < 0) {
                    dist[c2] = depth + 1;
                    next_frontier.push_back(c2);
                    ++reached;
                  }
                }
              }
            }
          }
          frontier.swap(next_frontier);
          ++depth;
        }
        if (reached < m) {
          // unreached checks exist: best girth choice
          for (int32_t c = 0; c < m; ++c)
            if (dist[c] < 0) cands.push_back(c);
        } else {
          int32_t far = 0;
          for (int32_t c = 0; c < m; ++c)
            if (dist[c] > far) far = dist[c];
          if (far == 0) {
            // degenerate: everything is a direct neighbor
            for (int32_t c = 0; c < m; ++c) cands.push_back(c);
          } else {
            for (int32_t c = 0; c < m; ++c)
              if (dist[c] == far) cands.push_back(c);
          }
        }
        // among candidates keep minimum current degree
        int64_t best = INT64_MAX;
        for (int32_t c : cands)
          if (check_deg[c] < best) best = check_deg[c];
        size_t w = 0;
        for (size_t i2 = 0; i2 < cands.size(); ++i2)
          if (check_deg[cands[i2]] == best) cands[w++] = cands[i2];
        cands.resize(w);
      }
      if (cands.empty()) return 2;
      int32_t c = cands[rng.below((uint32_t)cands.size())];
      var_checks[v].push_back(c);
      check_vars[c].push_back(v);
      ++check_deg[c];
    }
    std::sort(var_checks[v].begin(), var_checks[v].end());
    std::memcpy(out + (int64_t)v * dv, var_checks[v].data(),
                sizeof(int32_t) * dv);
  }
  return 0;
}

// ---------------------------------------------------------------- alist

namespace {
struct Tokens {
  const char* p;
  const char* end;
  bool ok = true;
  int64_t next() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p >= end) {
      ok = false;
      return 0;
    }
    bool neg = (*p == '-');
    if (neg) ++p;
    int64_t v = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      ++p;
      any = true;
    }
    if (!any) ok = false;
    return neg ? -v : v;
  }
};
}  // namespace

// Pass 1: header + degree sums.  dims_out: [n, m, dv_max, dc_max, q,
// padded_flag].  Returns 0 ok.
int alist_parse_dims(const char* text, int64_t len, int64_t* dims_out) {
  Tokens t{text, text + len};
  int64_t a = t.next(), b = t.next();
  if (!t.ok) return 1;
  // non-binary header has a third small integer before dv_max; disambiguate
  // by reading two more and checking consistency is impossible without
  // lookahead — caller passes expectations via alist_parse_fill instead.
  dims_out[0] = a;
  dims_out[1] = b;
  return 0;
}

// Full parse into padded arrays.  nonbinary: 0/1.  n, m, dv_max, dc_max
// must match the file (read them in Python first — cheap).  Outputs are
// int32 arrays: n_idx[n*dv_max], n_val[n*dv_max] (nonbinary only, else
// ignored), m_idx[m*dc_max], m_val[m*dc_max]; padding slots = -1 (idx).
// deg arrays: n_deg[n], m_deg[m].  Returns 0 ok.
int alist_parse_fill(const char* text, int64_t len, int32_t nonbinary,
                     int32_t n, int32_t m, int32_t dv_max, int32_t dc_max,
                     int32_t q, int32_t* n_deg, int32_t* m_deg,
                     int32_t* n_idx, int32_t* n_val, int32_t* m_idx,
                     int32_t* m_val) {
  Tokens t{text, text + len};
  int64_t fn = t.next(), fm = t.next();
  if (nonbinary) {
    int64_t fq = t.next();
    if (fq != q) return 3;
  }
  if (fn != n || fm != m) return 2;
  int64_t fdv = t.next(), fdc = t.next();
  if (fdv != dv_max || fdc != dc_max) return 4;
  for (int32_t i = 0; i < n; ++i) n_deg[i] = (int32_t)t.next();
  for (int32_t i = 0; i < m; ++i) m_deg[i] = (int32_t)t.next();
  if (!t.ok) return 5;

  // Detect padded vs unpadded adjacency by counting remaining tokens.
  int64_t sum_dv = 0, sum_dc = 0;
  for (int32_t i = 0; i < n; ++i) sum_dv += n_deg[i];
  for (int32_t i = 0; i < m; ++i) sum_dc += m_deg[i];
  Tokens probe = t;
  int64_t remaining = 0;
  while (true) {
    probe.next();
    if (!probe.ok) break;
    ++remaining;
  }
  int64_t per = nonbinary ? 2 : 1;
  bool padded =
      remaining >= per * ((int64_t)n * dv_max + (int64_t)m * dc_max);
  if (!padded && remaining < per * (sum_dv + sum_dc)) return 6;

  auto read_block = [&](int32_t rows, const int32_t* deg, int32_t width,
                        int32_t* idx, int32_t* val) -> int {
    for (int32_t i = 0; i < rows; ++i) {
      int32_t want = padded ? width : deg[i];
      int32_t got = 0;
      for (int32_t k2 = 0; k2 < want; ++k2) {
        int64_t e = t.next();
        int64_t v = nonbinary ? t.next() : 1;
        if (!t.ok) return 7;
        if (e == 0) continue;  // zero-padding entry
        if (got >= width) return 8;
        idx[(int64_t)i * width + got] = (int32_t)(e - 1);
        val[(int64_t)i * width + got] = (int32_t)v;
        ++got;
      }
      if (got != deg[i]) return 9;
      for (int32_t k2 = got; k2 < width; ++k2) {
        idx[(int64_t)i * width + k2] = -1;
        val[(int64_t)i * width + k2] = 0;
      }
    }
    return 0;
  };
  int rc = read_block(n, n_deg, dv_max, n_idx, n_val);
  if (rc) return rc;
  rc = read_block(m, m_deg, dc_max, m_idx, m_val);
  if (rc) return rc;
  return 0;
}

}  // extern "C"
