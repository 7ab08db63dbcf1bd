// vcfc_host: native host runtime for the device codec engine.
//
// The device kernels (vcfc_tpu.ops.rle) produce/consume *positional flag*
// matrices: a (L, S) uint8 plane holding the .vcfc flag byte at each
// segment's LAST sample position and 0 elsewhere (0 is never a legal
// flag byte; nonzero lane order == flag-stream order; end placement lets
// the device encoder emit lengths locally — see ops/rle.py).  This
// library is the thread-parallel byte plumbing between that dense device
// form and the ragged .vcfc stream:
//
//   * vcfc_scan          — walk a .vcfc stream: per-line offsets + headers
//   * vcfc_unpack        — file sample bytes -> positional flags, with
//                          escape-column discovery (two-phase: count, fill)
//   * vcfc_measure/write — two-pass encode assembly: per-line output sizes,
//                          then scatter-write every line into one output
//                          buffer at precomputed offsets (line-parallel)
//   * vcfc_measure_render/render — two-pass decode assembly: required blob
//                          + rendered sample text + escape splices
//   * vcfc_classify      — VCF sample fields -> genotype code matrix
//
// Exposed as a plain C ABI for ctypes.  No Python.h dependency.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

static inline void put_len_header(uint8_t* p, uint32_t len) {
  p[0] = static_cast<uint8_t>(((len >> 24) & 0x3F) | 0xC0);
  p[1] = static_cast<uint8_t>(len >> 16);
  p[2] = static_cast<uint8_t>(len >> 8);
  p[3] = static_cast<uint8_t>(len);
}

static inline int64_t get_len_header(const uint8_t* p) {
  if ((p[0] >> 6) != 3) return -1;
  return (static_cast<int64_t>(p[0] & 0x3F) << 24) |
         (static_cast<int64_t>(p[1]) << 16) |
         (static_cast<int64_t>(p[2]) << 8) | p[3];
}

static inline int64_t flag_run_len(uint8_t f) {
  if ((f & 0x80) == 0) return f & 0x7F;
  if ((f & 0xE0) == 0xE0) return f & 0x1F;  // escape column count
  return f & 0x1F;
}

static int n_workers(int64_t items) {
  // VCFC_WORKERS overrides hardware_concurrency AND the items/1024
  // amortization heuristic (exercises the multi-worker paths on
  // single-core machines; capping on shared hosts)
  if (const char* s = getenv("VCFC_WORKERS")) {
    long v = atol(s);
    if (v >= 1)
      return static_cast<int>(std::max<int64_t>(std::min<int64_t>(v, items), 1));
  }
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int64_t w = std::min<int64_t>(hw, (items + 1023) / 1024);
  return static_cast<int>(std::max<int64_t>(w, 1));
}

template <typename F>
static void parallel_for(int64_t n, F&& body) {
  int workers = n_workers(n);
  if (workers <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    int64_t lo = w * chunk, hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Walk a .vcfc stream, record line geometry.  Sequential (offsets chain),
// but touches only 8 header bytes per line.
// Returns number of lines, or negative on error (-2 = out capacity, -3 =
// malformed header).
extern "C" int64_t vcfc_scan(const uint8_t* raw, int64_t n, int64_t data_off,
                             int64_t max_lines, int64_t* line_off,
                             int32_t* line_len, int32_t* req_len) {
  int64_t off = data_off;
  int64_t count = 0;
  while (off < n) {
    if (off + 8 > n) return -3;
    int64_t ll = get_len_header(raw + off);
    int64_t rl = get_len_header(raw + off + 4);
    if (ll < 0 || rl < 0 || off + 4 + ll > n) return -3;
    if (count >= max_lines) return -2;
    line_off[count] = off;
    line_len[count] = static_cast<int32_t>(ll);
    req_len[count] = static_cast<int32_t>(rl);
    ++count;
    off += 4 + ll;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Decode-side unpack: .vcfc sample bytes -> positional flags.
//
// status[i]: 0 ok; 1 malformed (sample count mismatch / truncation);
//            2 unsupported shape (escape flag with count != 1) — the
//            caller routes such lines through the Python oracle.
// esc_count[i]: number of escape columns on line i.
//
// Phase 2 (vcfc_collect_escapes) re-walks escape lines, filling flattened
// arrays at caller-prefix-summed bases: for each escape column, its
// sample position, absolute byte offset of the ASCII, and byte length.
extern "C" void vcfc_unpack(const uint8_t* raw, const int64_t* line_off,
                            const int32_t* line_len, const int32_t* req_len,
                            int64_t L, int64_t S, int64_t W, uint8_t* flagpos,
                            int32_t* esc_count, uint8_t* status) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* body = raw + line_off[i] + 8 + req_len[i];
      const uint8_t* end =
          body + (static_cast<int64_t>(line_len[i]) - 4 - req_len[i] - 1);
      uint8_t* row = flagpos + i * W;
      const uint8_t* p = body;
      int64_t pos = 0;
      int32_t escs = 0;
      uint8_t st = 0;
      while (p < end) {
        uint8_t f = *p++;
        if ((f & 0xE0) == 0xE0) {
          int64_t n_cols = f & 0x1F;
          if (n_cols != 1) {
            st = 2;  // reference never emits this; oracle handles it
            break;
          }
          if (pos >= S) {
            st = 1;
            break;
          }
          row[pos] = f;
          // ASCII column runs to '\t' (consumed) or region end
          while (p < end && *p != '\t') ++p;
          bool last_sample = (pos == S - 1);
          if (p < end && *p == '\t') {
            if (last_sample) {
              st = 1;  // tab after final sample is malformed
              break;
            }
            ++p;
          } else if (!last_sample) {
            st = 1;  // mid-line escape must be tab-terminated
            break;
          }
          ++escs;
          ++pos;
        } else {
          int64_t rl = flag_run_len(f);
          if (rl == 0 || pos + rl > S) {  // also guards the row[] write
            st = 1;
            break;
          }
          pos += rl;
          row[pos - 1] = f;  // segment-end placement
        }
      }
      if (st == 0 && (pos != S || p != end)) st = 1;
      status[i] = st;
      esc_count[i] = escs;
    }
  });
}

// Packed variant of vcfc_unpack for the device-unpack decode route
// (ops/rle.py::unpack_packed_flags expands packed->positional with a
// batched matmul): emits each line's flag BYTES left-aligned into a (L, M) row
// instead of materializing the O(L*W) positional plane — host work and
// host->device traffic scale with the compressed size, not the cohort
// width.  Status/escape semantics identical to vcfc_unpack.
extern "C" void vcfc_scan_packed(const uint8_t* raw, const int64_t* line_off,
                                 const int32_t* line_len, const int32_t* req_len,
                                 int64_t L, int64_t S, int64_t M, uint8_t* packed,
                                 int32_t* nflags, int32_t* esc_count,
                                 uint8_t* status) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* body = raw + line_off[i] + 8 + req_len[i];
      const uint8_t* end =
          body + (static_cast<int64_t>(line_len[i]) - 4 - req_len[i] - 1);
      uint8_t* row = packed + i * M;
      const uint8_t* p = body;
      int64_t pos = 0;
      int32_t nf = 0;
      int32_t escs = 0;
      uint8_t st = 0;
      while (p < end) {
        uint8_t f = *p++;
        if (nf >= M) {
          st = 1;
          break;
        }
        if ((f & 0xE0) == 0xE0) {
          int64_t n_cols = f & 0x1F;
          if (n_cols != 1) {
            st = 2;  // reference never emits this; oracle handles it
            break;
          }
          if (pos >= S) {
            st = 1;
            break;
          }
          row[nf++] = f;
          while (p < end && *p != '\t') ++p;
          bool last_sample = (pos == S - 1);
          if (p < end && *p == '\t') {
            if (last_sample) {
              st = 1;
              break;
            }
            ++p;
          } else if (!last_sample) {
            st = 1;
            break;
          }
          ++escs;
          ++pos;
        } else {
          int64_t rl = flag_run_len(f);
          if (rl == 0 || pos + rl > S) {
            st = 1;
            break;
          }
          pos += rl;
          row[nf++] = f;
        }
      }
      if (st == 0 && (pos != S || p != end)) st = 1;
      status[i] = st;
      nflags[i] = nf;
      esc_count[i] = escs;
    }
  });
}

extern "C" void vcfc_collect_escapes(const uint8_t* raw, const int64_t* line_off,
                                     const int32_t* line_len,
                                     const int32_t* req_len,
                                     const int32_t* esc_count,
                                     const int64_t* esc_base, int64_t L,
                                     int64_t S, int32_t* esc_sample,
                                     int64_t* esc_off, int32_t* esc_len) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (esc_count[i] == 0) continue;
      const uint8_t* base = raw;
      const uint8_t* body = raw + line_off[i] + 8 + req_len[i];
      const uint8_t* end =
          body + (static_cast<int64_t>(line_len[i]) - 4 - req_len[i] - 1);
      const uint8_t* p = body;
      int64_t pos = 0;
      int64_t w = esc_base[i];
      const int64_t w_end = esc_base[i] + esc_count[i];
      while (p < end && w < w_end) {
        uint8_t f = *p++;
        if ((f & 0xE0) == 0xE0) {
          const uint8_t* start = p;
          while (p < end && *p != '\t') ++p;
          esc_sample[w] = static_cast<int32_t>(pos);
          esc_off[w] = start - base;
          esc_len[w] = static_cast<int32_t>(p - start);
          ++w;
          if (p < end && *p == '\t') ++p;
          ++pos;
        } else {
          pos += flag_run_len(f);
        }
      }
    }
  });
}

// ---------------------------------------------------------------------------
// Encode assembly from positional flags.
//
// Per line i (regular layout: every sample field is 3 ASCII bytes at
// sample_start[i] + 4*j):
//   required blob = body[line_start[i] .. sample_start[i])
//   flag at position j -> one output byte; escape flags additionally
//   splice the 3-byte field + '\t' unless j == S-1.
// Irregular lines have sizes[i] preset by the caller and are skipped.

extern "C" void vcfc_measure(const uint8_t* body, const int64_t* line_start,
                             const int64_t* sample_start,
                             const uint8_t* flagpos, const uint8_t* irregular,
                             int64_t L, int64_t W, int64_t S, int64_t* sizes) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (irregular[i]) continue;  // caller preset
      const uint8_t* row = flagpos + i * W;
      int64_t req = sample_start[i] - line_start[i];
      int64_t bytes = 0;
      for (int64_t j = 0; j < S; ++j) {
        uint8_t f = row[j];
        if (!f) continue;
        ++bytes;
        if ((f & 0xE0) == 0xE0) bytes += 3 + (j < S - 1 ? 1 : 0);
      }
      sizes[i] = 8 + req + bytes + 1;
    }
  });
}

extern "C" void vcfc_write(const uint8_t* body, const int64_t* line_start,
                           const int64_t* sample_start, const uint8_t* flagpos,
                           const uint8_t* irregular, const int64_t* out_off,
                           const int64_t* sizes, int64_t L, int64_t W,
                           int64_t S, uint8_t* out) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (irregular[i]) continue;  // caller splices these
      uint8_t* p = out + out_off[i];
      const uint8_t* row = flagpos + i * W;
      int64_t req = sample_start[i] - line_start[i];
      put_len_header(p, static_cast<uint32_t>(sizes[i] - 4));
      put_len_header(p + 4, static_cast<uint32_t>(req));
      p += 8;
      std::memcpy(p, body + line_start[i], static_cast<size_t>(req));
      p += req;
      for (int64_t j = 0; j < S; ++j) {
        uint8_t f = row[j];
        if (!f) continue;
        *p++ = f;
        if ((f & 0xE0) == 0xE0) {
          const uint8_t* field = body + sample_start[i] + 4 * j;
          *p++ = field[0];
          *p++ = field[1];
          *p++ = field[2];
          if (j < S - 1) *p++ = '\t';
        }
      }
      *p++ = '\n';
    }
  });
}

// ---------------------------------------------------------------------------
// Host-executor encode: genotype codes -> positional flags without the
// device (run-scan with the reference's caps: 127 for 0|0, 31 for the
// other phased GTs, 1 per escape; compress.cpp:126-127,171-185).
extern "C" void vcfc_rle_encode(const uint8_t* codes, int64_t L, int64_t W,
                                int64_t S, uint8_t* flagpos, int32_t* nseg) {
  static const uint8_t kBase[5] = {0x00, 0xA0, 0xC0, 0x80, 0xE0};
  static const int64_t kCap[5] = {127, 31, 31, 31, 1};
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* crow = codes + i * W;
      uint8_t* frow = flagpos + i * W;
      int64_t j = 0;
      int32_t count = 0;
      while (j < S) {
        uint8_t c = crow[j];
        int64_t k = j + 1;
        if (c != 4) {
          int64_t cap = kCap[c];
          while (k < S && crow[k] == c && k - j < cap) ++k;
        }
        frow[k - 1] = static_cast<uint8_t>(kBase[c] | (k - j));  // end placement
        ++count;
        j = k;
      }
      nseg[i] = count;
    }
  });
}

// ---------------------------------------------------------------------------
// Host-executor decode: expand positional flags to genotype codes without
// the device (run-fill).  Used when device transfers are the bottleneck
// (VCFC_EXECUTOR=host) and as the numpy-free fallback.
extern "C" void vcfc_expand_codes(const uint8_t* flagpos, int64_t L, int64_t W,
                                  int64_t S, uint8_t* codes) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* row = flagpos + i * W;
      uint8_t* crow = codes + i * W;
      int64_t j = 0;
      while (j < S) {
        // flags sit at segment ENDS: scan to the next flag, fill back
        int64_t e = j;
        while (e < S && !row[e]) ++e;
        if (e == S) break;  // malformed; caller validates via unpack status
        uint8_t f = row[e];
        uint8_t c;
        if ((f & 0x80) == 0) {
          c = 0;
        } else if ((f & 0xE0) == 0xE0) {
          c = 4;
        } else if ((f & 0xE0) == 0xA0) {
          c = 1;
        } else if ((f & 0xE0) == 0xC0) {
          c = 2;
        } else {
          c = 3;
        }
        std::memset(crow + j, c, static_cast<size_t>(e + 1 - j));
        j = e + 1;
      }
    }
  });
}

// ---------------------------------------------------------------------------
// Decode assembly: required blob + rendered sample text + escape splices.
// Output line size = req + (4*S - 1) + 1 + sum(esc_len - 3)  [escapes
// replace a 3-byte "?|?" placeholder].

extern "C" void vcfc_measure_render(const int32_t* req_len,
                                    const int32_t* esc_count,
                                    const int64_t* esc_base,
                                    const int32_t* esc_len, int64_t L,
                                    int64_t S, int64_t* sizes) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t extra = 0;
      int64_t b = esc_base[i];
      for (int32_t k = 0; k < esc_count[i]; ++k) extra += esc_len[b + k] - 3;
      sizes[i] = req_len[i] + (4 * S - 1) + 1 + extra;
    }
  });
}

// Expand genotype codes to "a|b\t" ASCII words: code c in 0..3 renders
// ('0'+(c>>1)) '|' ('0'+(c&1)) '\t' as one 32-bit store.
static inline uint32_t code_word(uint8_t c) {
  uint32_t b0 = '0' + (c >> 1), b2 = '0' + (c & 1);
  return b0 | ('|' << 8) | (b2 << 16) | (0x09u << 24);  // little-endian
}

static inline uint8_t* render_codes(uint8_t* p, const uint8_t* crow,
                                    int64_t j0, int64_t j1) {
  for (int64_t j = j0; j < j1; ++j) {
    uint32_t w = code_word(crow[j]);
    std::memcpy(p, &w, 4);
    p += 4;
  }
  return p;
}

extern "C" void vcfc_render(const uint8_t* raw, const int64_t* line_off,
                            const int32_t* req_len, const uint8_t* codes,
                            const int32_t* esc_count, const int64_t* esc_base,
                            const int32_t* esc_sample, const int64_t* esc_off,
                            const int32_t* esc_len, const uint8_t* skip,
                            const int64_t* out_off, int64_t L, int64_t CW,
                            int64_t S, uint8_t* out) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (skip[i]) continue;  // caller splices these (oracle lines)
      uint8_t* p = out + out_off[i];
      int64_t req = req_len[i];
      std::memcpy(p, raw + line_off[i] + 8, static_cast<size_t>(req));
      p += req;
      const uint8_t* crow = codes + i * CW;
      if (esc_count[i] == 0) {
        p = render_codes(p, crow, 0, S);
        --p;  // drop the trailing tab
      } else {
        int64_t b = esc_base[i];
        int64_t j = 0;  // sample cursor
        for (int32_t k = 0; k < esc_count[i]; ++k) {
          int64_t ej = esc_sample[b + k];
          p = render_codes(p, crow, j, ej);
          std::memcpy(p, raw + esc_off[b + k],
                      static_cast<size_t>(esc_len[b + k]));
          p += esc_len[b + k];
          if (ej < S - 1) *p++ = '\t';
          j = ej + 1;
        }
        if (j < S) {
          p = render_codes(p, crow, j, S);
          --p;  // drop the trailing tab
        }
      }
      *p++ = '\n';
    }
  });
}

// Text-plane variant of vcfc_render for the device-render route
// (VCFC_PARSE=device): the device already synthesized the "a|b\t" sample
// words (ops/rle.py::text_rle_decode), so sample runs are
// straight memcpys from the (L, TW)-byte text plane; escape columns
// still splice their raw ASCII over the device's "?|?" placeholder.
// Sizes and layout match vcfc_render exactly (vcfc_measure_render).
extern "C" void vcfc_render_text(const uint8_t* raw, const int64_t* line_off,
                                 const int32_t* req_len, const uint8_t* text,
                                 const int32_t* esc_count,
                                 const int64_t* esc_base,
                                 const int32_t* esc_sample,
                                 const int64_t* esc_off, const int32_t* esc_len,
                                 const uint8_t* skip, const int64_t* out_off,
                                 int64_t L, int64_t TW, int64_t S,
                                 uint8_t* out) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (skip[i]) continue;  // caller splices these (oracle lines)
      uint8_t* p = out + out_off[i];
      int64_t req = req_len[i];
      std::memcpy(p, raw + line_off[i] + 8, static_cast<size_t>(req));
      p += req;
      const uint8_t* trow = text + i * TW;
      if (esc_count[i] == 0) {
        // device words already end sample S-1 with '\n': one memcpy
        std::memcpy(p, trow, static_cast<size_t>(4 * S));
        p += 4 * S;
        continue;
      }
      int64_t b = esc_base[i];
      int64_t j = 0;  // sample cursor
      for (int32_t k = 0; k < esc_count[i]; ++k) {
        int64_t ej = esc_sample[b + k];
        std::memcpy(p, trow + 4 * j, static_cast<size_t>(4 * (ej - j)));
        p += 4 * (ej - j);
        std::memcpy(p, raw + esc_off[b + k],
                    static_cast<size_t>(esc_len[b + k]));
        p += esc_len[b + k];
        *p++ = (ej < S - 1) ? '\t' : '\n';
        j = ej + 1;
      }
      if (j < S) {
        std::memcpy(p, trow + 4 * j, static_cast<size_t>(4 * (S - j)));
        p += 4 * (S - j);
      }
    }
  });
}

// ---------------------------------------------------------------------------
// Canonical Huffman decode for the .vcfz container: flat table lookup over
// a MAX_CODE_LEN-bit window (table built host-side).  Sequential in the
// bit stream, but blocks decode independently — callers parallelize at
// the block level.
extern "C" int64_t vcfz_huffman_decode(const uint8_t* payload, int64_t n_bytes,
                                       int64_t n_symbols,
                                       const int32_t* sym_table,
                                       const uint8_t* len_table,
                                       int32_t window_bits, int32_t* out) {
  uint64_t acc = 0;   // bit accumulator, MSB-first
  int navail = 0;     // bits in acc
  int64_t byte_pos = 0;
  const uint64_t mask = (1u << window_bits) - 1;
  for (int64_t i = 0; i < n_symbols; ++i) {
    while (navail < window_bits) {
      uint8_t b = byte_pos < n_bytes ? payload[byte_pos++] : 0;
      acc = (acc << 8) | b;
      navail += 8;
    }
    uint32_t prefix = (acc >> (navail - window_bits)) & mask;
    uint8_t ln = len_table[prefix];
    if (ln == 0) return -1;  // invalid prefix
    out[i] = sym_table[prefix];
    navail -= ln;
  }
  return 0;
}

// Context-switching variant (.vcfz v2): the table used for each symbol is
// selected by the class of the previously decoded symbol (class_of, one
// byte per alphabet symbol); ctx_init seeds each block.  Tables are
// concatenated per-context: sym_tables[ctx * (1<<window_bits) + prefix].
extern "C" int64_t vcfz_huffman_decode_ctx(
    const uint8_t* payload, int64_t n_bytes, int64_t n_symbols,
    const int32_t* sym_tables, const uint8_t* len_tables,
    const uint8_t* class_of, int32_t ctx_init, int32_t window_bits,
    int32_t* out) {
  uint64_t acc = 0;
  int navail = 0;
  int64_t byte_pos = 0;
  const uint64_t mask = (1u << window_bits) - 1;
  const int64_t table_size = int64_t(1) << window_bits;
  int32_t ctx = ctx_init;
  for (int64_t i = 0; i < n_symbols; ++i) {
    while (navail < window_bits) {
      uint8_t b = byte_pos < n_bytes ? payload[byte_pos++] : 0;
      acc = (acc << 8) | b;
      navail += 8;
    }
    uint32_t prefix = (acc >> (navail - window_bits)) & mask;
    const int64_t base = ctx * table_size;
    uint8_t ln = len_tables[base + prefix];
    if (ln == 0) return -1;
    int32_t sym = sym_tables[base + prefix];
    out[i] = sym;
    navail -= ln;
    ctx = class_of[sym];
  }
  return 0;
}

// v7 context-split merge: replay the context automaton over decoded
// per-context sub-streams (subs concatenated; offsets[n_ctx+1] are the
// boundaries).  Symbol-level O(total) — the bit-level entropy decode of
// each sub-stream happened independently (block/device-parallel) before
// this.  Returns -1 on sub-stream underrun (corrupt counts).
extern "C" int64_t vcfz_merge_ctx(const int32_t* subs, const int64_t* offsets,
                                  int32_t n_ctx, const uint8_t* class_of,
                                  int64_t alphabet, int32_t ctx_init,
                                  int64_t total, int32_t* out) {
  if (n_ctx <= 0 || n_ctx > 64) return -1;
  int64_t idx[64];
  for (int32_t c = 0; c < n_ctx; ++c) idx[c] = offsets[c];
  int32_t ctx = ctx_init;
  if (ctx < 0 || ctx >= n_ctx) return -1;
  for (int64_t i = 0; i < total; ++i) {
    if (idx[ctx] >= offsets[ctx + 1]) return -1;
    const int32_t s = subs[idx[ctx]++];
    if (s < 0 || s >= alphabet) return -1;
    out[i] = s;
    ctx = class_of[s];
    if (ctx >= n_ctx) return -1;
  }
  return 0;
}

// Compact positional flags to per-line value streams (the .vcfz symbol
// extraction): out[base[i]..] receives line i's nonzero flag bytes in
// sample order.  Thread-parallel over lines.
extern "C" void vcfc_compact_flags(const uint8_t* flagpos, int64_t L, int64_t W,
                                   const int64_t* base, uint8_t* out) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* row = flagpos + i * W;
      uint8_t* dst = out + base[i];
      for (int64_t j = 0; j < W; ++j) {
        uint8_t v = row[j];
        if (v) *dst++ = v;
      }
    }
  });
}

// Context-switching canonical Huffman ENCODE (.vcfz writer): MSB-first
// bit packing of a symbol stream, table selected by the class of the
// previous symbol.  Tables are (n_ctx, alphabet); ctx_init seeds the
// stream (blocks are packed independently).  Returns bytes written, or
// -1 on a symbol without a codeword / output overflow.
extern "C" int64_t vcfz_huffman_encode_ctx(
    const int32_t* symbols, int64_t n_symbols, const uint32_t* codes,
    const uint8_t* lengths, const uint8_t* class_of, int32_t ctx_init,
    int64_t alphabet, uint8_t* out, int64_t out_cap) {
  uint64_t acc = 0;
  int nbits = 0;
  int64_t pos = 0;
  int32_t ctx = ctx_init;
  for (int64_t i = 0; i < n_symbols; ++i) {
    int32_t sym = symbols[i];
    if (sym < 0 || sym >= alphabet) return -1;
    const int64_t base = int64_t(ctx) * alphabet + sym;
    uint8_t ln = lengths[base];
    if (ln == 0) return -1;
    acc = (acc << ln) | codes[base];
    nbits += ln;
    while (nbits >= 8) {
      if (pos >= out_cap) return -1;
      out[pos++] = uint8_t((acc >> (nbits - 8)) & 0xFF);
      nbits -= 8;
    }
    ctx = class_of[sym];
  }
  if (nbits > 0) {
    if (pos >= out_cap) return -1;
    out[pos++] = uint8_t((acc << (8 - nbits)) & 0xFF);
  }
  return pos;
}

// ---------------------------------------------------------------------------
// VCF text line indexing (encode parse): find every data line's start, end
// (exclusive of '\n') and sample start (after the 9th tab).  Two-phase and
// chunk-parallel: phase 1 counts lines per chunk, the caller prefix-sums,
// phase 2 fills.  A line with fewer than 9 tabs gets sample_start = -1.

static int64_t chunk_of(int64_t n, int64_t workers, int64_t w) {
  return (n * w) / workers;
}

extern "C" int64_t vcfc_count_lines(const uint8_t* raw, int64_t n,
                                    int64_t data_off, int64_t workers,
                                    int64_t* per_chunk) {
  const uint8_t* base = raw + data_off;
  int64_t len = n - data_off;
  std::vector<std::thread> ts;
  for (int64_t w = 0; w < workers; ++w) {
    ts.emplace_back([&, w] {
      int64_t lo = chunk_of(len, workers, w), hi = chunk_of(len, workers, w + 1);
      // own lines whose newline falls in [lo, hi)
      int64_t count = 0;
      const uint8_t* p = base + lo;
      const uint8_t* end = base + hi;
      while (p < end) {
        const uint8_t* nl =
            static_cast<const uint8_t*>(memchr(p, '\n', end - p));
        if (!nl) break;
        ++count;
        p = nl + 1;
      }
      // final chunk also owns a trailing newline-less line
      if (w == workers - 1 && len > 0 && base[len - 1] != '\n') ++count;
      per_chunk[w] = count;
    });
  }
  for (auto& t : ts) t.join();
  int64_t total = 0;
  for (int64_t w = 0; w < workers; ++w) total += per_chunk[w];
  return total;
}

extern "C" void vcfc_index_lines(const uint8_t* raw, int64_t n,
                                 int64_t data_off, int64_t workers,
                                 const int64_t* chunk_base, int64_t* line_start,
                                 int64_t* line_end, int64_t* sample_start) {
  const uint8_t* base = raw + data_off;
  int64_t len = n - data_off;
  std::vector<std::thread> ts;
  for (int64_t w = 0; w < workers; ++w) {
    ts.emplace_back([&, w] {
      int64_t lo = chunk_of(len, workers, w), hi = chunk_of(len, workers, w + 1);
      int64_t idx = chunk_base[w];
      // the line owning the newline at/after lo starts after the previous
      // newline (scan back from lo)
      int64_t start = lo;
      while (start > 0 && base[start - 1] != '\n') --start;
      const uint8_t* p = base + start;
      const uint8_t* end = base + hi;
      const uint8_t* hard_end = base + len;
      while (p < hard_end) {
        const uint8_t* nl =
            static_cast<const uint8_t*>(memchr(p, '\n', hard_end - p));
        const uint8_t* eol = nl ? nl : hard_end;
        if (nl && nl >= end) break;           // owned by the next chunk
        if (!nl && w != workers - 1) break;   // trailing line owned by last
        line_start[idx] = p - base;
        line_end[idx] = eol - base;
        // 9th tab
        const uint8_t* q = p;
        int tabs = 0;
        const uint8_t* found = nullptr;
        while (q < eol) {
          const uint8_t* tb =
              static_cast<const uint8_t*>(memchr(q, '\t', eol - q));
          if (!tb) break;
          if (++tabs == 9) {
            found = tb;
            break;
          }
          q = tb + 1;
        }
        sample_start[idx] = found ? (found + 1 - base) : -1;
        ++idx;
        if (!nl) break;
        p = nl + 1;
      }
    });
  }
  for (auto& t : ts) t.join();
}

// Gather each regular line's genotype region (4*S-1 bytes at
// sample_start[i]) into a fixed-stride text plane for the device
// classify route (VCFC_PARSE=device): the plane viewed as int32 is one
// little-endian "a|b\t" word per sample field.  Irregular lines stay
// zero (the device classifies zeros as escapes; the caller's irregular
// mask routes those rows to the oracle regardless).
extern "C" void vcfc_gather_text(const uint8_t* body,
                                 const int64_t* sample_start,
                                 const uint8_t* irregular, int64_t L, int64_t S,
                                 int64_t TW, uint8_t* text) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (irregular[i]) continue;
      std::memcpy(text + i * TW, body + sample_start[i],
                  static_cast<size_t>(4 * S - 1));
    }
  });
}

// ---------------------------------------------------------------------------
// VCF sample-field classification (encode parse fast path): for each line,
// sample fields at sample_start[i] + 4*j (3-byte layout).  Emits code 0..3
// for the biallelic phased GTs, 4 otherwise.  Verifies the 4-byte layout
// (separators must be tabs); sets regular[i] = 0 on mismatch.
extern "C" void vcfc_classify(const uint8_t* body, const int64_t* sample_start,
                              const int64_t* line_end, int64_t L, int64_t S,
                              uint8_t* codes, uint8_t* regular) {
  parallel_for(L, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (!regular[i]) continue;
      if (line_end[i] - sample_start[i] != 4 * S - 1) {
        regular[i] = 0;
        continue;
      }
      const uint8_t* base = body + sample_start[i];
      uint8_t* crow = codes + i * S;
      bool ok = true;
      for (int64_t j = 0; j < S; ++j) {
        const uint8_t* f = base + 4 * j;
        uint8_t b0 = f[0], b1 = f[1], b2 = f[2];
        if (j < S - 1 && f[3] != '\t') {
          ok = false;
          break;
        }
        if (b1 == '|' && (b0 == '0' || b0 == '1') && (b2 == '0' || b2 == '1')) {
          crow[j] = static_cast<uint8_t>((b0 - '0') * 2 + (b2 - '0'));
        } else {
          crow[j] = 4;
        }
      }
      if (!ok) regular[i] = 0;
    }
  });
}
