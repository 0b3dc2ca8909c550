/* zstd encoder (RFC 8878): one frame that libzstd and zstd_dec.c read.
 *
 * A single-segment frame header with the content size and no checksum,
 * then blocks of at most 128 KiB. Each block is matched greedily against
 * a hash table of the caller's min_match-byte prefixes over the whole
 * frame (the repeat offsets tried first), and written compressed:
 * literals Huffman-coded in
 * one or four streams (the tree's weights given directly or FSE-coded,
 * whichever is smaller; beyond 128 symbols FSE-coded), or raw or RLE where
 * that is not larger; sequences with each of the three FSE tables
 * predefined, RLE or compressed, whichever costs fewest bits. A block
 * whose compressed form is not smaller is stored raw, one byte repeated
 * as an RLE block. There is one setting: the one the reference's stores
 * name (blosc clevel 3), whose sizes land within about 2 % of c-blosc's
 * (libzstd level 5) on bitshuffled image planes; the bytes are not
 * libzstd's. */
#include <stdlib.h>
#include <string.h>

#include "mmr_host.h"

#define ZSTD_MAGIC 0xFD2FB528u
#define BLOCK_MAX (128 * 1024)
#define HASH_LOG 15
#define MIN_MATCH 4   /* the shortest match min_match may ask for */
#define MATCH_PLAIN 4 /* mmr_zstd_compress's */
#define HUF_MAX_BITS 11
#define SEQ_MAX (BLOCK_MAX / MIN_MATCH + 1)
#define BLOCK_OUT (BLOCK_MAX + 1024) /* a block's scratch output: past this it goes raw */

static inline int highbit(uint32_t v) { return 31 - __builtin_clz(v | 1); }

static inline uint64_t rd64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

static inline void wr16(uint8_t *p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
}

/* --------------------------------------------------------------- bit writer */
/* Bits appended upward from bit 0 of the first byte; a reader of the
 * format takes them back from the end, the last written first. */
typedef struct {
  uint8_t *p, *end;
  uint64_t acc;
  unsigned n;
  int full;
} bitw;

static void bw_init(bitw *w, uint8_t *dst, size_t cap) {
  w->p = dst;
  w->end = dst + cap;
  w->acc = 0;
  w->n = 0;
  w->full = 0;
}

/* v < 2^nb; at most 56 bits between flushes */
static inline void bw_add(bitw *w, uint64_t v, unsigned nb) {
  w->acc |= v << w->n;
  w->n += nb;
}

static inline void bw_flush(bitw *w) {
  if (w->end - w->p < 8) {
    w->full = 1;
    w->n &= 7; /* keep going harmlessly: the caller sees `full` */
    return;
  }
  memcpy(w->p, &w->acc, 8);
  unsigned bytes = w->n >> 3;
  w->p += bytes;
  w->n &= 7;
  w->acc = bytes ? (bytes == 8 ? 0 : w->acc >> (8 * bytes)) : w->acc;
}

/* the end marker (a 1 bit) and the last partial byte; the stream's size,
 * 0 where it did not fit */
static size_t bw_close(bitw *w, uint8_t *start) {
  bw_add(w, 1, 1);
  bw_flush(w);
  if (w->full) return 0;
  if (w->n) {
    w->p++;
    w->n = 0;
  }
  return (size_t)(w->p - start);
}

/* ---------------------------------------------------------------- FSE tables */
typedef struct {
  int32_t delta_find;
  uint32_t delta_nb;
} fse_sym;

typedef struct {
  int log;
  uint16_t state[512];
  fse_sym sym[256];
} fse_ct;

/* The encoding table of a normalized distribution, spread as every reader
 * of the format spreads it (RFC 8878 4.1.1). */
static void fse_build(fse_ct *t, const int16_t *norm, int max_sym, int log) {
  int size = 1 << log, mask = size - 1, high = size - 1, step = (size >> 1) + (size >> 3) + 3;
  uint8_t spread[512];
  uint32_t cumul[257];
  cumul[0] = 0;
  for (int s = 1; s <= max_sym + 1; s++) {
    if (norm[s - 1] == -1) {
      cumul[s] = cumul[s - 1] + 1;
      spread[high--] = (uint8_t)(s - 1);
    } else {
      cumul[s] = cumul[s - 1] + (uint32_t)norm[s - 1];
    }
  }
  int pos = 0;
  for (int s = 0; s <= max_sym; s++)
    for (int i = 0; i < norm[s]; i++) {
      spread[pos] = (uint8_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  for (int u = 0; u < size; u++) t->state[cumul[spread[u]]++] = (uint16_t)(size + u);
  uint32_t total = 0;
  for (int s = 0; s <= max_sym; s++) {
    int c = norm[s];
    if (c == 0) {
      t->sym[s].delta_nb = ((uint32_t)(log + 1) << 16) - (uint32_t)size;
      t->sym[s].delta_find = 0;
    } else if (c == -1 || c == 1) {
      t->sym[s].delta_nb = ((uint32_t)log << 16) - (uint32_t)size;
      t->sym[s].delta_find = (int32_t)total - 1;
      total++;
    } else {
      uint32_t max_out = (uint32_t)(log - highbit((uint32_t)c - 1));
      t->sym[s].delta_nb = (max_out << 16) - ((uint32_t)c << max_out);
      t->sym[s].delta_find = (int32_t)total - c;
      total += (uint32_t)c;
    }
  }
  t->log = log;
}

/* A state that decodes to symbol s, reached without writing bits. */
static inline uint32_t fse_init_state(const fse_ct *t, int s) {
  uint32_t nb = (t->sym[s].delta_nb + (1u << 15)) >> 16;
  uint32_t v = (nb << 16) - t->sym[s].delta_nb;
  return t->state[(int32_t)(v >> nb) + t->sym[s].delta_find];
}

static inline void fse_encode(bitw *w, const fse_ct *t, uint32_t *state, int s) {
  uint32_t nb = (*state + t->sym[s].delta_nb) >> 16;
  bw_add(w, *state & ((1u << nb) - 1), nb);
  *state = t->state[(int32_t)(*state >> nb) + t->sym[s].delta_find];
}

static inline void fse_flush_state(bitw *w, const fse_ct *t, uint32_t state) {
  bw_add(w, state & ((1u << t->log) - 1), (unsigned)t->log);
}

/* The table log for n symbols of alphabet [0, max_sym] (libzstd's rule). */
static int fse_log(int max_log, size_t n, int max_sym) {
  if (n < 2) return 5;
  int log = max_log, src_bits = highbit((uint32_t)(n - 1)) - 2;
  int min_bits = highbit((uint32_t)(n - 1)) + 1, sym_bits = highbit((uint32_t)max_sym) + 2;
  if (sym_bits < min_bits) min_bits = sym_bits;
  if (src_bits < log) log = src_bits;
  if (min_bits > log) log = min_bits;
  if (log < 5) log = 5;
  if (log > max_log) log = max_log;
  return log;
}

/* count[0 .. max_sym] (n in all) scaled to sum 2^log, every present symbol
 * at least 1; -1 if more symbols are present than the table holds */
static int fse_normalize(int16_t *norm, const uint32_t *count, int max_sym, size_t n, int log) {
  int size = 1 << log, sum = 0, present = 0;
  for (int s = 0; s <= max_sym; s++) {
    if (!count[s]) {
      norm[s] = 0;
      continue;
    }
    present++;
    uint64_t scaled = ((uint64_t)count[s] << log) + n / 2;
    int v = (int)(scaled / n);
    norm[s] = (int16_t)(v < 1 ? 1 : v);
    sum += norm[s];
  }
  if (present > size || present < 2) return -1;
  while (sum > size) { /* take from the symbol that loses least: most states per count */
    int best = -1;
    uint64_t best_key = 0;
    for (int s = 0; s <= max_sym; s++) {
      if (norm[s] <= 1) continue;
      uint64_t key = ((uint64_t)norm[s] << 32) / count[s];
      if (best < 0 || key > best_key) best = s, best_key = key;
    }
    if (best < 0) return -1;
    norm[best]--;
    sum--;
  }
  while (sum < size) { /* give to the symbol that gains most: fewest states per count */
    int best = -1;
    uint64_t best_key = 0;
    for (int s = 0; s <= max_sym; s++) {
      if (!count[s]) continue;
      uint64_t key = ((uint64_t)norm[s] << 32) / count[s];
      if (best < 0 || key < best_key) best = s, best_key = key;
    }
    norm[best]++;
    sum++;
  }
  return 0;
}

/* The normalized counts' description (RFC 8878 4.1.1), read forward. */
static size_t fse_write_ncount(uint8_t *dst, size_t cap, const int16_t *norm, int max_sym,
                               int log) {
  uint8_t *p = dst;
  uint64_t acc = (uint64_t)(log - 5);
  unsigned n = 4;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, s = 0, prev0 = 0;
#define NC_FLUSH()                                   \
  while (n >= 8) {                                   \
    if (p >= dst + cap) return 0;                    \
    *p++ = (uint8_t)acc;                             \
    acc >>= 8;                                       \
    n -= 8;                                          \
  }
  while (s <= max_sym && remaining > 1) {
    if (prev0) {
      int start = s;
      while (s <= max_sym && !norm[s]) s++;
      if (s > max_sym) return 0;
      while (s >= start + 3) {
        start += 3;
        acc |= (uint64_t)3 << n;
        n += 2;
        NC_FLUSH();
      }
      acc |= (uint64_t)(s - start) << n;
      n += 2;
      NC_FLUSH();
    }
    int count = norm[s++], max = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count++;
    if (count >= threshold) count += max;
    acc |= (uint64_t)count << n;
    n += (unsigned)nbits - (count < max);
    prev0 = count == 1;
    if (remaining < 1) return 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
    NC_FLUSH();
  }
  if (remaining != 1) return 0;
  while (n > 0) {
    if (p >= dst + cap) return 0;
    *p++ = (uint8_t)acc;
    acc >>= 8;
    n = n > 8 ? n - 8 : 0;
  }
#undef NC_FLUSH
  return (size_t)(p - dst);
}

/* ------------------------------------------------------------------ Huffman */
/* Code lengths of at most HUF_MAX_BITS for the present symbols of
 * count[0 .. max_sym], a complete prefix code; the longest length, or 0
 * with fewer than two symbols present. */
static int huf_lengths(const uint32_t *count, int max_sym, uint8_t *len) {
  int sym[256], n = 0;
  for (int s = 0; s <= max_sym; s++) {
    len[s] = 0;
    if (count[s]) sym[n++] = s;
  }
  if (n < 2) return 0;
  for (int i = 1; i < n; i++) { /* by count ascending (insertion: n <= 256) */
    int s = sym[i], j = i;
    while (j > 0 && count[sym[j - 1]] > count[s]) {
      sym[j] = sym[j - 1];
      j--;
    }
    sym[j] = s;
  }
  /* two-queue Huffman: leaves 0 .. n-1, internal nodes n .. 2n-2 */
  uint64_t w[512];
  int parent[512];
  for (int i = 0; i < n; i++) w[i] = count[sym[i]];
  int leaf = 0, node = n, made = n;
  for (int k = 0; k < n - 1; k++) {
    int pick[2];
    for (int t = 0; t < 2; t++) {
      if (leaf < n && (node >= made || w[leaf] <= w[node]))
        pick[t] = leaf++;
      else
        pick[t] = node++;
    }
    w[made] = w[pick[0]] + w[pick[1]];
    parent[pick[0]] = parent[pick[1]] = made;
    made++;
  }
  int depth[512];
  depth[made - 1] = 0;
  for (int i = made - 2; i >= 0; i--) depth[i] = depth[parent[i]] + 1;
  int lmax = 0;
  const int L = HUF_MAX_BITS;
  int64_t kraft = 0;
  for (int i = 0; i < n; i++) {
    int d = depth[i] > L ? L : depth[i];
    len[sym[i]] = (uint8_t)d;
    kraft += (int64_t)1 << (L - d);
  }
  /* clamped codes overfill the code space: lengthen the longest codes
   * below the limit (the rarest such symbols) until they fit */
  while (kraft > ((int64_t)1 << L)) {
    int best = -1;
    for (int i = 0; i < n; i++) {
      int l = len[sym[i]];
      if (l < L && (best < 0 || l > len[sym[best]])) best = i;
    }
    len[sym[best]]++;
    kraft -= (int64_t)1 << (L - len[sym[best]]);
  }
  /* and fill what is left, shortening the commonest codes that fit */
  while (kraft < ((int64_t)1 << L)) {
    int best = -1;
    for (int i = n - 1; i >= 0; i--) {
      int l = len[sym[i]];
      if (l > 1 && ((int64_t)1 << (L - l)) <= ((int64_t)1 << L) - kraft &&
          (best < 0 || l > len[sym[best]]))
        best = i;
    }
    if (best < 0) return 0;
    kraft += (int64_t)1 << (L - len[sym[best]]);
    len[sym[best]]--;
  }
  for (int i = 0; i < n; i++)
    if (len[sym[i]] > lmax) lmax = len[sym[i]];
  return lmax;
}

/* The canonical codes the format's readers derive from the weights
 * (weight = lmax + 1 - length): codes assigned by weight ascending, then
 * by symbol. */
static void huf_codes(const uint8_t *len, int max_sym, int lmax, uint16_t *code) {
  uint32_t start[16] = {0}, count[16] = {0};
  for (int s = 0; s <= max_sym; s++)
    if (len[s]) count[lmax + 1 - len[s]]++;
  for (int wt = 1, cur = 0; wt <= lmax; wt++) {
    start[wt] = (uint32_t)cur;
    cur += (int)(count[wt] << (wt - 1));
  }
  for (int s = 0; s <= max_sym; s++) {
    if (!len[s]) continue;
    int wt = lmax + 1 - len[s];
    code[s] = (uint16_t)(start[wt] >> (wt - 1));
    start[wt] += 1u << (wt - 1);
  }
}

/* The weights of symbols 0 .. max_sym - 1 (the last implied), FSE-coded
 * with two interleaved states; its size, or 0 where it does not fit in
 * 127 bytes or the weights take one value */
static size_t huf_weights_fse(uint8_t *dst, const uint8_t *wt, int nw) {
  uint32_t count[13] = {0};
  int max_w = 0;
  for (int i = 0; i < nw; i++) {
    count[wt[i]]++;
    if (wt[i] > max_w) max_w = wt[i];
  }
  int16_t norm[13];
  int log = fse_log(6, (size_t)nw, max_w);
  if (nw < 2 || fse_normalize(norm, count, max_w, (size_t)nw, log)) return 0;
  uint8_t buf[160];
  size_t h = fse_write_ncount(buf, sizeof buf, norm, max_w, log);
  if (!h) return 0;
  fse_ct t;
  fse_build(&t, norm, max_w, log);
  bitw w;
  bw_init(&w, buf + h, sizeof buf - h);
  uint32_t st[2];
  st[(nw - 1) & 1] = fse_init_state(&t, wt[nw - 1]);
  st[(nw - 2) & 1] = fse_init_state(&t, wt[nw - 2]);
  for (int i = nw - 3; i >= 0; i--) {
    fse_encode(&w, &t, &st[i & 1], wt[i]);
    if (!(i & 3)) bw_flush(&w);
  }
  fse_flush_state(&w, &t, st[1]);
  fse_flush_state(&w, &t, st[0]);
  size_t s = bw_close(&w, buf + h);
  if (!s || h + s > 127) return 0;
  memcpy(dst, buf, h + s);
  return h + s;
}

/* The tree description: its size in dst (<= 129 bytes), or 0 */
static size_t huf_write_tree(uint8_t *dst, const uint8_t *len, int max_sym, int lmax) {
  uint8_t wt[256];
  int nw = max_sym; /* weights of symbols 0 .. max_sym - 1 */
  for (int s = 0; s < nw; s++) wt[s] = len[s] ? (uint8_t)(lmax + 1 - len[s]) : 0;
  uint8_t fse[128];
  size_t f = huf_weights_fse(fse, wt, nw);
  size_t direct = nw <= 128 ? 1 + (size_t)(nw + 1) / 2 : 0;
  if (f && (!direct || 1 + f < direct)) {
    dst[0] = (uint8_t)f;
    memcpy(dst + 1, fse, f);
    return 1 + f;
  }
  if (!direct) return 0;
  dst[0] = (uint8_t)(127 + nw);
  for (int i = 0; i < nw; i += 2)
    dst[1 + i / 2] = (uint8_t)(wt[i] << 4 | (i + 1 < nw ? wt[i + 1] : 0));
  return direct;
}

/* src[0 .. n) Huffman-coded as one stream: written last symbol first, so a
 * reader from the stream's end gets them in order */
static size_t huf_stream(uint8_t *dst, size_t cap, const uint8_t *src, size_t n,
                         const uint16_t *code, const uint8_t *len) {
  bitw w;
  bw_init(&w, dst, cap);
  size_t i = n;
  while (i & 3) {
    i--;
    bw_add(&w, code[src[i]], len[src[i]]);
  }
  bw_flush(&w);
  while (i) { /* 4 x 11 bits between flushes */
    i -= 4;
    bw_add(&w, code[src[i + 3]], len[src[i + 3]]);
    bw_add(&w, code[src[i + 2]], len[src[i + 2]]);
    bw_add(&w, code[src[i + 1]], len[src[i + 1]]);
    bw_add(&w, code[src[i]], len[src[i]]);
    bw_flush(&w);
  }
  return bw_close(&w, dst);
}

static size_t lit_header_size(size_t n) { return n <= 31 ? 1 : n <= 4095 ? 2 : 3; }

static size_t lit_raw_header(uint8_t *dst, size_t n, int type) {
  if (n <= 31) {
    dst[0] = (uint8_t)(type | n << 3);
    return 1;
  }
  if (n <= 4095) {
    wr16(dst, (uint32_t)(type | 1 << 2 | n << 4));
    return 2;
  }
  uint32_t v = (uint32_t)(type | 3 << 2 | n << 4);
  dst[0] = (uint8_t)v;
  dst[1] = (uint8_t)(v >> 8);
  dst[2] = (uint8_t)(v >> 16);
  return 3;
}

/* The literals section of lit[0 .. n) into dst (room for n + 8 bytes):
 * Huffman-coded where that is smaller, else RLE or raw. */
static size_t literals(uint8_t *dst, const uint8_t *lit, size_t n) {
  uint32_t count[256] = {0};
  int max_sym = 0, distinct = 0;
  for (size_t i = 0; i < n; i++) count[lit[i]]++;
  for (int s = 0; s < 256; s++)
    if (count[s]) max_sym = s, distinct++;
  if (n > 0 && distinct == 1) {
    size_t h = lit_raw_header(dst, n, 1);
    dst[h] = lit[0];
    return h + 1;
  }
  if (n >= 64) {
    uint8_t len[256];
    uint16_t code[256];
    int lmax = huf_lengths(count, max_sym, len);
    uint64_t bits = 0;
    for (int s = 0; s <= max_sym; s++) bits += (uint64_t)count[s] * len[s];
    int single = n < 256;
    size_t hs = n <= 1023 ? 3 : n <= 16383 ? 4 : 5;
    /* worth trying when the streams alone save more than the tree costs */
    if (lmax && bits / 8 + 6 + 4 + hs + 16 < n) {
      uint8_t *p = dst + hs;
      size_t tree = huf_write_tree(p, len, max_sym, lmax), comp = 0;
      if (tree) {
        huf_codes(len, max_sym, lmax, code);
        uint8_t *q = p + tree;
        size_t room = n - tree; /* anything larger is no gain */
        if (single) {
          comp = huf_stream(q, room, lit, n, code, len);
          if (comp) comp += tree;
        } else if (room > 6) {
          size_t seg = (n + 3) / 4, total = 6, sz[4];
          for (int k = 0; k < 4 && total; k++) {
            size_t cnt = k < 3 ? seg : n - 3 * seg;
            sz[k] = huf_stream(q + total, room - total, lit + k * seg, cnt, code, len);
            total = sz[k] && (k == 3 || sz[k] <= 0xFFFF) ? total + sz[k] : 0;
          }
          if (total) {
            wr16(q, (uint32_t)sz[0]);
            wr16(q + 2, (uint32_t)sz[1]);
            wr16(q + 4, (uint32_t)sz[2]);
            comp = tree + total;
          }
        }
        if (comp && hs + comp < lit_header_size(n) + n) {
          uint64_t v = 2 | (uint64_t)(single ? 0 : hs == 3 ? 1 : hs == 4 ? 2 : 3) << 2 |
                       (uint64_t)n << 4;
          v |= (uint64_t)comp << (hs == 3 ? 14 : hs == 4 ? 18 : 22);
          for (size_t k = 0; k < hs; k++) dst[k] = (uint8_t)(v >> (8 * k));
          return hs + comp;
        }
      }
    }
  }
  size_t h = lit_raw_header(dst, n, 0);
  memcpy(dst + h, lit, n);
  return h + n;
}

/* -------------------------------------------------------------- sequences */
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  1,  1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,  12,   13,   14,   15,    16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint32_t ML_BASE[53] = {
    3,   4,   5,   6,   7,    8,    9,    10,   11,   12,    13,    14,    15,   16,
    17,  18,  19,  20,  21,   22,   23,   24,   25,   26,    27,    28,    29,   30,
    31,  32,  33,  34,  35,   37,   39,   41,   43,   47,    51,    59,    67,   83,
    99,  131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const int16_t LL_DEF[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                   2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEF[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEF[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

static inline int ll_code(uint32_t ll) {
  static const uint8_t CODE[64] = {
      0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 16, 17, 17, 18, 18,
      19, 19, 20, 20, 20, 20, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 22, 23, 23, 23, 23,
      23, 23, 23, 23, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24};
  return ll < 64 ? CODE[ll] : highbit(ll) + 19;
}

static inline int ml_code(uint32_t ml_base) { /* match length - 3 */
  static const uint8_t CODE[128] = {
      0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
      22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 32, 33, 33, 34, 34, 35, 35, 36, 36, 36, 36,
      37, 37, 37, 37, 38, 38, 38, 38, 38, 38, 38, 38, 39, 39, 39, 39, 39, 39, 39, 39, 40, 40,
      40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 41, 41, 41, 41, 41, 41, 41, 41,
      41, 41, 41, 41, 41, 41, 41, 41, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42,
      42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42};
  return ml_base < 128 ? CODE[ml_base] : highbit(ml_base) + 36;
}

typedef struct {
  uint32_t ll, ml, ofb; /* literal length, match length, offset value (RFC's Offset_Value) */
} seq_t;

struct mmr_zstd_enc {
  uint32_t table[1 << HASH_LOG];
  seq_t seq[SEQ_MAX];
  uint8_t code[3][SEQ_MAX]; /* LL, OF, ML codes */
  uint8_t lit[BLOCK_MAX + 8];
  uint8_t out[BLOCK_OUT];
  fse_ct ct[3];
};

mmr_zstd_enc *mmr_zstd_enc_new(void) { return malloc(sizeof(mmr_zstd_enc)); }

void mmr_zstd_enc_free(mmr_zstd_enc *z) { free(z); }

/* The offset value for a match at offset `off` after `ll` literals, and the
 * repeat offsets updated as a reader updates them. */
static inline uint32_t offset_value(uint32_t *rep, uint32_t off, uint32_t ll) {
  uint32_t ofb;
  if (ll) {
    ofb = off == rep[0] ? 1 : off == rep[1] ? 2 : off == rep[2] ? 3 : off + 3;
  } else {
    ofb = off == rep[1] ? 1 : off == rep[2] ? 2 : off == rep[0] - 1 ? 3 : off + 3;
  }
  if (ofb > 3) {
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = off;
  } else {
    int idx = (int)ofb - 1 + (ll == 0);
    if (idx == 1) {
      rep[1] = rep[0];
      rep[0] = off;
    } else if (idx >= 2) {
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = off;
    }
  }
  return ofb;
}

/* bytes a[0..] and b[0..] agree on, up to a + k == end */
static inline size_t match_len(const uint8_t *a, const uint8_t *b, const uint8_t *end) {
  const uint8_t *start = a;
  while (a + 8 <= end) {
    uint64_t x = rd64(a) ^ rd64(b);
    if (x) return (size_t)(a - start) + ((unsigned)__builtin_ctzll(x) >> 3);
    a += 8;
    b += 8;
  }
  while (a < end && *a == *b) a++, b++;
  return (size_t)(a - start);
}

/* the first min_match bytes at p (8 readable; mask ~0 >> (64 - 8 min_match)) */
static inline uint64_t key_at(const uint8_t *p, uint64_t mask) { return rd64(p) & mask; }

static inline uint32_t hash_key(uint64_t k) {
  return (uint32_t)((k * 0x9E3779B185EBCA87ull) >> (64 - HASH_LOG));
}

/* Greedy matching of base[start .. end) (matches reach back to base[0]),
 * matches of mm bytes or more; the sequences in z->seq, the literals in
 * z->lit; returns the count of sequences, *nlit the literals' count (the
 * last run included). */
static size_t find_matches(mmr_zstd_enc *z, const uint8_t *base, size_t start, size_t end,
                           size_t mm, uint32_t *rep, size_t *nlit) {
  const uint64_t mask = ~0ull >> (64 - 8 * mm);
  const uint8_t *ip = base + start, *anchor = ip, *iend = base + end;
  const uint8_t *ilimit = end - start >= 16 ? iend - 8 : ip;
  uint8_t *lp = z->lit;
  size_t ns = 0;
  uint32_t *table = z->table;
  while (ip < ilimit) {
    uint64_t cur = key_at(ip, mask);
    uint32_t h = hash_key(cur);
    const uint8_t *cand = base + table[h];
    table[h] = (uint32_t)(ip - base);
    const uint8_t *m = NULL, *at = ip;
    /* the last offset, one byte on (zstd's fast strategy) */
    if ((size_t)(ip + 1 - base) > rep[0] && key_at(ip + 1, mask) == key_at(ip + 1 - rep[0], mask)) {
      at = ip + 1;
      m = at - rep[0];
    } else if (cand < ip && key_at(cand, mask) == cur) {
      m = cand;
    }
    if (!m) {
      ip += 1 + ((size_t)(ip - anchor) >> 7);
      continue;
    }
    size_t ml = mm + match_len(at + mm, m + mm, iend);
    while (at > anchor && m > base && at[-1] == m[-1]) at--, m--, ml++;
    uint32_t ll = (uint32_t)(at - anchor);
    memcpy(lp, anchor, ll);
    lp += ll;
    z->seq[ns].ll = ll;
    z->seq[ns].ml = (uint32_t)ml;
    z->seq[ns].ofb = offset_value(rep, (uint32_t)(at - m), ll);
    ns++;
    ip = at + ml;
    anchor = ip;
    if (ip < ilimit) /* a position inside the match, for later ones */
      table[hash_key(key_at(ip - 2, mask))] = (uint32_t)(ip - 2 - base);
    /* matches at the second repeat offset right after this one */
    while (ip < ilimit && (size_t)(ip - base) > rep[1] && key_at(ip, mask) == key_at(ip - rep[1], mask)) {
      size_t ml2 = mm + match_len(ip + mm, ip + mm - rep[1], iend);
      z->seq[ns].ll = 0;
      z->seq[ns].ml = (uint32_t)ml2;
      z->seq[ns].ofb = offset_value(rep, rep[1], 0);
      ns++;
      table[hash_key(key_at(ip, mask))] = (uint32_t)(ip - base);
      ip += ml2;
      anchor = ip;
    }
  }
  size_t tail = (size_t)(iend - anchor);
  memcpy(lp, anchor, tail);
  lp += tail;
  *nlit = (size_t)(lp - z->lit);
  return ns;
}

/* Estimated bits of count[] coded with norm (log), in 1/256 bits;
 * UINT64_MAX where a present symbol has no state. */
static uint64_t fse_cost(const uint32_t *count, int max_sym, const int16_t *norm, int norm_max,
                         int log) {
  uint64_t bits = 0;
  for (int s = 0; s <= max_sym; s++) {
    if (!count[s]) continue;
    if (s > norm_max || norm[s] == 0) return UINT64_MAX;
    uint32_t c = norm[s] < 0 ? 1 : (uint32_t)norm[s];
    int hb = highbit(c); /* log2(c) ~ hb + frac, frac linear */
    uint32_t l2 = ((uint32_t)hb << 8) + (((c << 8) >> hb) - 256);
    bits += (uint64_t)count[s] * (((uint32_t)log << 8) - l2);
  }
  return bits;
}

/* One of the three tables: its mode (0 predefined, 1 RLE, 2 compressed),
 * its description written at *pp, z->ct[k] built */
static int seq_table(fse_ct *ct, uint8_t **pp, uint8_t *end, const uint8_t *codes, size_t ns,
                     int max_code, const int16_t *def, int def_max, int def_log, int max_log) {
  uint32_t count[53] = {0};
  int max_sym = 0, distinct = 0;
  for (size_t i = 0; i < ns; i++) count[codes[i]]++;
  for (int s = 0; s <= max_code; s++)
    if (count[s]) max_sym = s, distinct++;
  if (distinct == 1 && ns > 2) {
    if (*pp >= end) return -1;
    *(*pp)++ = (uint8_t)max_sym;
    ct->log = 0;
    return 1;
  }
  uint64_t def_cost = fse_cost(count, max_sym, def, def_max, def_log);
  int16_t norm[53];
  int log = fse_log(max_log, ns, max_sym);
  if (ns >= 8 && distinct > 1 && !fse_normalize(norm, count, max_sym, ns, log)) {
    uint8_t hdr[128];
    size_t h = fse_write_ncount(hdr, sizeof hdr, norm, max_sym, log);
    uint64_t cost = fse_cost(count, max_sym, norm, max_sym, log);
    if (h && cost + ((uint64_t)h << 11) < def_cost) {
      if ((size_t)(end - *pp) < h) return -1;
      memcpy(*pp, hdr, h);
      *pp += h;
      fse_build(ct, norm, max_sym, log);
      return 2;
    }
  }
  if (def_cost == UINT64_MAX) { /* a code the predefined table lacks, few sequences */
    uint32_t c2[53];
    memcpy(c2, count, sizeof c2);
    log = 5;
    if (fse_normalize(norm, c2, max_sym, ns, log)) {
      if (distinct != 1 || *pp >= end) return -1;
      *(*pp)++ = (uint8_t)max_sym; /* one code: RLE */
      ct->log = 0;
      return 1;
    }
    size_t h = fse_write_ncount(*pp, (size_t)(end - *pp), norm, max_sym, log);
    if (!h) return -1;
    *pp += h;
    fse_build(ct, norm, max_sym, log);
    return 2;
  }
  fse_build(ct, def, def_max, def_log);
  return 0;
}

/* The sequences section into [p, end); its end, or NULL where it does
 * not fit */
static uint8_t *sequences(mmr_zstd_enc *z, size_t ns, uint8_t *p, uint8_t *end) {
  if (end - p < 4) return NULL;
  if (ns < 128) {
    *p++ = (uint8_t)ns;
  } else if (ns < 0x7F00) {
    *p++ = (uint8_t)((ns >> 8) + 128);
    *p++ = (uint8_t)ns;
  } else {
    *p++ = 255;
    wr16(p, (uint32_t)(ns - 0x7F00));
    p += 2;
  }
  if (!ns) return p;
  uint8_t *llc = z->code[0], *ofc = z->code[1], *mlc = z->code[2];
  for (size_t i = 0; i < ns; i++) {
    llc[i] = (uint8_t)ll_code(z->seq[i].ll);
    ofc[i] = (uint8_t)highbit(z->seq[i].ofb);
    mlc[i] = (uint8_t)ml_code(z->seq[i].ml - 3);
  }
  uint8_t *modes = p++;
  int m_ll = seq_table(&z->ct[0], &p, end, llc, ns, 35, LL_DEF, 35, 6, 9);
  if (m_ll < 0) return NULL;
  int m_of = seq_table(&z->ct[1], &p, end, ofc, ns, 31, OF_DEF, 28, 5, 8);
  if (m_of < 0) return NULL;
  int m_ml = seq_table(&z->ct[2], &p, end, mlc, ns, 52, ML_DEF, 52, 6, 9);
  if (m_ml < 0) return NULL;
  *modes = (uint8_t)(m_ll << 6 | m_of << 4 | m_ml << 2);
  const fse_ct *tl = &z->ct[0], *to = &z->ct[1], *tm = &z->ct[2];
  int rl = m_ll == 1, ro = m_of == 1, rm = m_ml == 1;
  bitw w;
  bw_init(&w, p, (size_t)(end - p));
  size_t last = ns - 1;
  uint32_t sl = rl ? 0 : fse_init_state(tl, llc[last]);
  uint32_t so = ro ? 0 : fse_init_state(to, ofc[last]);
  uint32_t sm = rm ? 0 : fse_init_state(tm, mlc[last]);
  bw_add(&w, z->seq[last].ll - LL_BASE[llc[last]], LL_BITS[llc[last]]);
  bw_add(&w, z->seq[last].ml - ML_BASE[mlc[last]], ML_BITS[mlc[last]]);
  bw_flush(&w);
  bw_add(&w, z->seq[last].ofb & ((1u << ofc[last]) - 1), ofc[last]);
  bw_flush(&w);
  for (size_t i = last; i-- > 0;) {
    if (!ro) fse_encode(&w, to, &so, ofc[i]);
    if (!rm) fse_encode(&w, tm, &sm, mlc[i]);
    if (!rl) fse_encode(&w, tl, &sl, llc[i]);
    bw_flush(&w);
    bw_add(&w, z->seq[i].ll - LL_BASE[llc[i]], LL_BITS[llc[i]]);
    bw_add(&w, z->seq[i].ml - ML_BASE[mlc[i]], ML_BITS[mlc[i]]);
    bw_flush(&w);
    bw_add(&w, z->seq[i].ofb & ((1u << ofc[i]) - 1), ofc[i]);
    bw_flush(&w);
    if (w.full) return NULL;
  }
  if (!rm) fse_flush_state(&w, tm, sm);
  if (!ro) fse_flush_state(&w, to, so);
  if (!rl) fse_flush_state(&w, tl, sl);
  size_t s = bw_close(&w, p);
  return s ? p + s : NULL;
}

/* base[start .. end) as a compressed block's content in z->out; its size,
 * or 0 where it is not smaller than the raw block */
static size_t compress_block(mmr_zstd_enc *z, const uint8_t *base, size_t start, size_t end,
                             size_t mm, uint32_t *rep) {
  size_t n = end - start, nlit;
  size_t ns = find_matches(z, base, start, end, mm, rep, &nlit);
  uint8_t *p = z->out, *oend = z->out + (n < BLOCK_OUT ? n : BLOCK_OUT);
  if (nlit + 8 > BLOCK_OUT) return 0;
  size_t l = literals(p, z->lit, nlit);
  if (l >= n) return 0;
  p += l;
  uint8_t *q = sequences(z, ns, p, oend);
  if (!q || q >= oend) return 0;
  return (size_t)(q - z->out);
}

int mmr_zstd_compress_with(mmr_zstd_enc *z, const uint8_t *src, size_t n, size_t min_match,
                           uint8_t *dst, size_t cap, size_t *written, char *err,
                           size_t errlen) {
  *written = 0;
  if (min_match < MIN_MATCH || min_match > 8)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED, "zstd matches of %zu bytes or more",
                         min_match);
  if (cap < mmr_zstd_compress_bound(n))
    return mmr_set_error(err, errlen, MMR_CORRUPT,
                         "zstd output buffer of %zu bytes, %zu bytes of input need %zu", cap,
                         n, mmr_zstd_compress_bound(n));
  if (n > 0xFFFFFFFFu - 16)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED,
                         "zstd input of %zu bytes (this encoder takes less than 4 GiB)", n);
  uint8_t *op = dst;
  memcpy(op, &(uint32_t){ZSTD_MAGIC}, 4);
  op += 4;
  if (n < 256) {
    *op++ = 0x20;
    *op++ = (uint8_t)n;
  } else if (n < 65536 + 256) {
    *op++ = 0x60;
    wr16(op, (uint32_t)(n - 256));
    op += 2;
  } else {
    *op++ = 0xA0;
    uint32_t v = (uint32_t)n;
    memcpy(op, &v, 4);
    op += 4;
  }
  memset(z->table, 0, sizeof z->table);
  uint32_t rep[3] = {1, 4, 8};
  size_t pos = 0;
  do {
    size_t bn = n - pos < BLOCK_MAX ? n - pos : BLOCK_MAX;
    int last = pos + bn == n;
    uint32_t saved[3] = {rep[0], rep[1], rep[2]};
    size_t c = 0;
    int rle = bn > 0;
    for (size_t i = 1; i < bn && rle; i++) rle = src[pos + i] == src[pos];
    if (!rle && bn >= 32) c = compress_block(z, src, pos, pos + bn, min_match, rep);
    uint32_t bh;
    if (rle) {
      bh = (uint32_t)(last | 1 << 1 | bn << 3);
      wr16(op, bh);
      op[2] = (uint8_t)(bh >> 16);
      op[3] = src[pos];
      op += 4;
    } else if (c && c < bn) {
      bh = (uint32_t)(last | 2 << 1 | c << 3);
      wr16(op, bh);
      op[2] = (uint8_t)(bh >> 16);
      memcpy(op + 3, z->out, c);
      op += 3 + c;
    } else {
      memcpy(rep, saved, sizeof rep); /* a raw block's reader keeps the offsets */
      bh = (uint32_t)(last | bn << 3);
      wr16(op, bh);
      op[2] = (uint8_t)(bh >> 16);
      memcpy(op + 3, src + pos, bn);
      op += 3 + bn;
    }
    pos += bn;
  } while (pos < n);
  *written = (size_t)(op - dst);
  return MMR_OK;
}

size_t mmr_zstd_compress_bound(size_t n) { return 4 + 1 + 4 + 3 * (n / BLOCK_MAX + 1) + n; }

int mmr_zstd_compress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap, size_t *written,
                      char *err, size_t errlen) {
  mmr_zstd_enc *z = mmr_zstd_enc_new();
  *written = 0;
  if (!z) return mmr_set_error(err, errlen, MMR_NOMEM, "out of memory");
  int rc = mmr_zstd_compress_with(z, src, n, MATCH_PLAIN, dst, cap, written, err, errlen);
  mmr_zstd_enc_free(z);
  return rc;
}
