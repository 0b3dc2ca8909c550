/* zstd decoder (RFC 8878): every frame of a buffer into one flat output.
 *
 * Blocks raw, RLE and compressed; literals raw, RLE, Huffman-coded in one
 * or four streams, and treeless (the frame's previous table); sequences
 * with FSE tables in predefined, RLE, compressed and repeat modes, the
 * three repeat offsets. The whole frame lands in the caller's buffer, so
 * a match may reach anywhere back to the frame's first byte and no window
 * buffer is kept. Skippable frames are skipped; content checksums are not
 * verified; a dictionary ID other than 0 is refused. Every read and write
 * is bounds-checked: damaged input gives MMR_CORRUPT. */
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "mmr_host.h"

#define ZSTD_MAGIC 0xFD2FB528u
#define BLOCK_MAX (128 * 1024)

int mmr_set_error(char *err, size_t errlen, int code, const char *fmt, ...) {
  if (err && errlen) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(err, errlen, fmt, ap);
    va_end(ap);
  }
  return code;
}

static inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

static inline uint32_t le16(const uint8_t *p) { return p[0] | (uint32_t)p[1] << 8; }

static inline uint32_t le32(const uint8_t *p) {
  return p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}

/* 8 bytes at src[at] little-endian, zero beyond src[n - 1] */
static inline uint64_t load64(const uint8_t *src, size_t n, size_t at) {
  uint64_t v = 0;
  if (at + 8 <= n)
    memcpy(&v, src + at, 8);
  else if (at < n)
    memcpy(&v, src + at, n - at);
  return v;
}

/* ------------------------------------------------------------------ bits */
/* A bitstream read backward from its end marker: pos = bits still unread.
 * Bits below the stream's start read as zero; pos < 0 means the reader
 * went past the start ("overflow" in the format's terms). */
typedef struct {
  const uint8_t *src;
  size_t n;
  int64_t pos;
} bitr;

static int bitr_init(bitr *b, const uint8_t *src, size_t n) {
  if (n == 0 || src[n - 1] == 0) return -1;
  b->src = src;
  b->n = n;
  b->pos = (int64_t)(n - 1) * 8 + highbit(src[n - 1]);
  return 0;
}

static inline uint64_t bitr_peek(const bitr *b, int nb) { /* nb <= 56 */
  int64_t start = b->pos - nb;
  if (nb == 0) return 0;
  if (start >= 0)
    return (load64(b->src, b->n, (size_t)(start >> 3)) >> (start & 7)) &
           ((1ull << nb) - 1);
  if (b->pos <= 0) return 0;
  return (load64(b->src, b->n, 0) & ((1ull << b->pos) - 1)) << (-start);
}

static inline uint64_t bitr_read(bitr *b, int nb) {
  uint64_t v = bitr_peek(b, nb);
  b->pos -= nb;
  return v;
}

/* ------------------------------------------------------------------- FSE */
typedef struct {
  uint8_t sym, nb;
  uint16_t base;
} fse_cell;

typedef struct {
  int log, valid;
  fse_cell c[512];
} fse_t;

/* A normalized-count table description read forward (RFC 8878 4.1.1).
 * *max_sym: in, the largest symbol allowed; out, the last one described. */
static int read_ncount(const uint8_t *src, size_t n, int16_t *norm, int *max_sym,
                       int *log_out, int max_log, size_t *used) {
  uint64_t pos = 0, total = (uint64_t)n * 8;
#define PEEK(k) ((load64(src, n, (size_t)(pos >> 3)) >> (pos & 7)) & ((1ull << (k)) - 1))
  if (n < 1) return -1;
  int log = (int)PEEK(4) + 5;
  pos += 4;
  if (log > max_log) return -1;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int s = 0, prev0 = 0;
  while (remaining > 1) {
    if (prev0) {
      int rep;
      do {
        rep = (int)PEEK(2);
        pos += 2;
        for (int k = 0; k < rep; k++) {
          if (s > *max_sym) return -1;
          norm[s++] = 0;
        }
      } while (rep == 3 && pos <= total);
    }
    if (s > *max_sym || pos > total) return -1;
    int max = (2 * threshold - 1) - remaining, count = (int)PEEK(nbits - 1);
    if (count < max) {
      pos += nbits - 1;
    } else {
      count = (int)PEEK(nbits);
      if (count >= threshold) count -= max;
      pos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[s++] = (int16_t)count;
    prev0 = count == 0;
    if (remaining < 1 || pos > total) return -1;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
#undef PEEK
  *max_sym = s - 1;
  *log_out = log;
  *used = (size_t)((pos + 7) / 8);
  return 0;
}

static int build_fse(fse_t *t, const int16_t *norm, int max_sym, int log) {
  int size = 1 << log, high = size - 1, mask = size - 1, pos = 0;
  int step = (size >> 1) + (size >> 3) + 3;
  uint16_t next[256];
  t->valid = 0;
  for (int s = 0; s <= max_sym; s++) {
    if (norm[s] == -1) {
      if (high < 0) return -1;
      t->c[high--].sym = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)norm[s];
    }
  }
  for (int s = 0; s <= max_sym; s++)
    for (int i = 0; i < norm[s]; i++) {
      t->c[pos].sym = (uint8_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) return -1;
  for (int u = 0; u < size; u++) {
    uint32_t ns = next[t->c[u].sym]++;
    int nb = log - highbit(ns);
    t->c[u].nb = (uint8_t)nb;
    t->c[u].base = (uint16_t)((ns << nb) - size);
  }
  t->log = log;
  t->valid = 1;
  return 0;
}

/* --------------------------------------------------------------- Huffman */
typedef struct {
  uint8_t sym, nb;
} huf_cell;

typedef struct {
  int bits, valid;
  huf_cell c[1 << 12];
} huf_t;

typedef struct {
  huf_t huf;
  fse_t ll, of, ml, tmp;
  uint64_t rep[3];
  uint8_t lit[BLOCK_MAX];
} zctx;

/* The Huffman tree description (RFC 8878 4.2.1): weights FSE-coded or
 * four bits each, the last weight implied. */
static int read_huf(zctx *z, const uint8_t *src, size_t n, size_t *used) {
  uint8_t w[256];
  int nw = 0;
  if (n < 1) return -1;
  int hb = src[0];
  if (hb < 128) {
    int16_t norm[256];
    int max_sym = 255, log;
    size_t hu;
    bitr b;
    if (hb == 0 || (size_t)hb + 1 > n) return -1;
    if (read_ncount(src + 1, hb, norm, &max_sym, &log, 6, &hu)) return -1;
    if (build_fse(&z->tmp, norm, max_sym, log)) return -1;
    if (hu >= (size_t)hb || bitr_init(&b, src + 1 + hu, hb - hu)) return -1;
    const fse_cell *c = z->tmp.c;
    int s1 = (int)bitr_read(&b, log), s2 = (int)bitr_read(&b, log);
    for (;;) {
      if (nw > 253) return -1;
      w[nw++] = c[s1].sym;
      s1 = c[s1].base + (int)bitr_read(&b, c[s1].nb);
      if (b.pos < 0) {
        w[nw++] = c[s2].sym;
        break;
      }
      w[nw++] = c[s2].sym;
      s2 = c[s2].base + (int)bitr_read(&b, c[s2].nb);
      if (b.pos < 0) {
        w[nw++] = c[s1].sym;
        break;
      }
    }
    *used = 1 + (size_t)hb;
  } else {
    nw = hb - 127;
    size_t bytes = (size_t)(nw + 1) / 2;
    if (1 + bytes > n) return -1;
    for (int i = 0; i < nw; i++)
      w[i] = (i & 1) ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4;
    *used = 1 + bytes;
  }
  uint32_t total = 0, count[13] = {0}, start[13] = {0};
  for (int i = 0; i < nw; i++) {
    if (w[i] > 12) return -1;
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) return -1;
  int bits = highbit(total) + 1;
  if (bits > 12) return -1;
  uint32_t rest = (1u << bits) - total;
  if (rest & (rest - 1)) return -1;
  w[nw] = (uint8_t)(highbit(rest) + 1);
  for (int i = 0; i <= nw; i++) count[w[i]]++;
  for (uint32_t wt = 1, cur = 0; wt <= (uint32_t)bits; wt++) {
    start[wt] = cur;
    cur += count[wt] << (wt - 1);
  }
  for (int s = 0; s <= nw; s++) {
    int wt = w[s];
    if (!wt) continue;
    huf_cell cell = {(uint8_t)s, (uint8_t)(bits + 1 - wt)};
    for (uint32_t k = 0, len = 1u << (wt - 1); k < len; k++) z->huf.c[start[wt]++] = cell;
  }
  z->huf.bits = bits;
  z->huf.valid = 1;
  return 0;
}

static int huf_stream(const huf_t *h, const uint8_t *src, size_t n, uint8_t *dst,
                      size_t cnt) {
  bitr b;
  if (bitr_init(&b, src, n)) return -1;
  for (size_t i = 0; i < cnt; i++) {
    huf_cell c = h->c[bitr_peek(&b, h->bits)];
    dst[i] = c.sym;
    b.pos -= c.nb;
  }
  return b.pos == 0 ? 0 : -1;
}

/* The literals section: *lit points at the block's literals (in src for
 * raw literals, else in z->lit). */
static int literals(zctx *z, const uint8_t *src, size_t n, const uint8_t **lit,
                    size_t *nlit, size_t *used) {
  if (n < 1) return -1;
  int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t regen, comp, hs;
  if (type < 2) {
    if (sf == 0 || sf == 2) {
      hs = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      hs = 2;
      if (n < 2) return -1;
      regen = (src[0] >> 4) + ((size_t)src[1] << 4);
    } else {
      hs = 3;
      if (n < 3) return -1;
      regen = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)src[2] << 12);
    }
    if (regen > BLOCK_MAX) return -1;
    if (type == 0) {
      if (hs + regen > n) return -1;
      *lit = src + hs;
      *used = hs + regen;
    } else {
      if (hs + 1 > n) return -1;
      memset(z->lit, src[hs], regen);
      *lit = z->lit;
      *used = hs + 1;
    }
    *nlit = regen;
    return 0;
  }
  if (sf < 2) {
    hs = 3;
    if (n < 3) return -1;
    uint32_t v = src[0] | (uint32_t)src[1] << 8 | (uint32_t)src[2] << 16;
    regen = (v >> 4) & 0x3FF;
    comp = (v >> 14) & 0x3FF;
  } else if (sf == 2) {
    hs = 4;
    if (n < 4) return -1;
    uint32_t v = le32(src);
    regen = (v >> 4) & 0x3FFF;
    comp = v >> 18;
  } else {
    hs = 5;
    if (n < 5) return -1;
    uint64_t v = le32(src) | (uint64_t)src[4] << 32;
    regen = (v >> 4) & 0x3FFFF;
    comp = (v >> 22) & 0x3FFFF;
  }
  if (hs + comp > n || regen > BLOCK_MAX) return -1;
  const uint8_t *p = src + hs;
  size_t left = comp;
  if (type == 2) {
    size_t hu;
    if (read_huf(z, p, left, &hu) || hu > left) return -1;
    p += hu;
    left -= hu;
  } else if (!z->huf.valid) {
    return -1;
  }
  if (sf == 0) {
    if (huf_stream(&z->huf, p, left, z->lit, regen)) return -1;
  } else {
    if (left < 6) return -1;
    size_t sz[4] = {le16(p), le16(p + 2), le16(p + 4), 0};
    if (6 + sz[0] + sz[1] + sz[2] > left) return -1;
    sz[3] = left - 6 - sz[0] - sz[1] - sz[2];
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) return -1;
    const uint8_t *q = p + 6;
    for (int i = 0; i < 4; i++) {
      size_t cnt = i < 3 ? seg : regen - 3 * seg;
      if (huf_stream(&z->huf, q, sz[i], z->lit + i * seg, cnt)) return -1;
      q += sz[i];
    }
  }
  *lit = z->lit;
  *nlit = regen;
  *used = hs + comp;
  return 0;
}

/* ------------------------------------------------------------- sequences */
static const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,  12,   13,   14,   15,    16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  1,  1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3,   4,   5,   6,   7,    8,    9,    10,   11,   12,    13,    14,    15,   16,
    17,  18,  19,  20,  21,   22,   23,   24,   25,   26,    27,    28,    29,   30,
    31,  32,  33,  34,  35,   37,   39,   41,   43,   47,    51,    59,    67,   83,
    99,  131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const int16_t LL_DEF[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                   2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEF[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEF[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

static int seq_table(fse_t *t, int mode, const int16_t *def, int def_max, int def_log,
                     int max_sym, int max_log, const uint8_t *src, size_t n,
                     size_t *used) {
  int16_t norm[256];
  *used = 0;
  switch (mode) {
    case 0:
      return build_fse(t, def, def_max, def_log);
    case 1:
      if (n < 1 || src[0] > max_sym) return -1;
      t->log = 0;
      t->c[0] = (fse_cell){src[0], 0, 0};
      t->valid = 1;
      *used = 1;
      return 0;
    case 2: {
      int log, ms = max_sym;
      if (read_ncount(src, n, norm, &ms, &log, max_log, used)) return -1;
      return build_fse(t, norm, ms, log);
    }
    default:
      return t->valid ? 0 : -1;
  }
}

/* One compressed block of src[0 .. n) to *op; fstart: the frame's first
 * output byte, oend: the buffer's end. */
static int block(zctx *z, const uint8_t *src, size_t n, uint8_t *fstart, uint8_t **opp,
                 uint8_t *oend) {
  const uint8_t *lit;
  size_t nlit, used;
  if (literals(z, src, n, &lit, &nlit, &used)) return -1;
  const uint8_t *p = src + used, *end = src + n, *lend = lit + nlit;
  uint8_t *op = *opp;
  size_t nseq = 0;
  if (p >= end) return -1;
  if (p[0] < 128) {
    nseq = p[0];
    p += 1;
  } else if (p[0] < 255) {
    if (end - p < 2) return -1;
    nseq = ((size_t)(p[0] - 128) << 8) + p[1];
    p += 2;
  } else {
    if (end - p < 3) return -1;
    nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
    p += 3;
  }
  if (nseq) {
    if (p >= end) return -1;
    int modes = *p++;
    if (modes & 3) return -1;
    if (seq_table(&z->ll, modes >> 6, LL_DEF, 35, 6, 35, 9, p, end - p, &used)) return -1;
    p += used;
    if (seq_table(&z->of, (modes >> 4) & 3, OF_DEF, 28, 5, 31, 8, p, end - p, &used))
      return -1;
    p += used;
    if (seq_table(&z->ml, (modes >> 2) & 3, ML_DEF, 52, 6, 52, 9, p, end - p, &used))
      return -1;
    p += used;
    bitr b;
    if (p > end || bitr_init(&b, p, end - p)) return -1;
    const fse_cell *llc = z->ll.c, *ofc = z->of.c, *mlc = z->ml.c;
    uint32_t lls = (uint32_t)bitr_read(&b, z->ll.log);
    uint32_t ofs = (uint32_t)bitr_read(&b, z->of.log);
    uint32_t mls = (uint32_t)bitr_read(&b, z->ml.log);
    uint64_t *rep = z->rep;
    for (size_t i = 0; i < nseq; i++) {
      int lcode = llc[lls].sym, ocode = ofc[ofs].sym, mcode = mlc[mls].sym;
      if (lcode > 35 || mcode > 52 || ocode > 31) return -1;
      uint64_t ofv = (1ull << ocode) + bitr_read(&b, ocode);
      uint64_t ml = ML_BASE[mcode] + bitr_read(&b, ML_BITS[mcode]);
      uint64_t ll = LL_BASE[lcode] + bitr_read(&b, LL_BITS[lcode]);
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        int idx = (int)ofv - 1 + (ll == 0);
        if (idx == 0) {
          off = rep[0];
        } else if (idx == 1) {
          off = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        } else {
          off = idx == 2 ? rep[2] : rep[0] - 1;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        lls = llc[lls].base + (uint32_t)bitr_read(&b, llc[lls].nb);
        mls = mlc[mls].base + (uint32_t)bitr_read(&b, mlc[mls].nb);
        ofs = ofc[ofs].base + (uint32_t)bitr_read(&b, ofc[ofs].nb);
      }
      if (ll > (uint64_t)(lend - lit) || ll + ml > (uint64_t)(oend - op)) return -1;
      memcpy(op, lit, ll);
      op += ll;
      lit += ll;
      if (off == 0 || off > (uint64_t)(op - fstart)) return -1;
      const uint8_t *m = op - off;
      if (off >= ml) {
        memcpy(op, m, ml);
        op += ml;
      } else {
        for (uint64_t k = 0; k < ml; k++) *op++ = *m++;
      }
    }
    if (b.pos != 0) return -1;
  }
  if ((size_t)(lend - lit) > (size_t)(oend - op)) return -1;
  memcpy(op, lit, lend - lit);
  op += lend - lit;
  *opp = op;
  return 0;
}

static int frame(zctx *z, const uint8_t *src, size_t n, size_t *in_used, uint8_t *oend,
                 uint8_t **opp, char *err, size_t errlen) {
  size_t p = 4;
#define NEED(k)                                                                   \
  if ((k) > n - p)                                                               \
    return mmr_set_error(err, errlen, MMR_CORRUPT, "zstd frame truncated at byte %zu", p)
  NEED(1);
  int fhd = src[p++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  if (fhd & 8) return mmr_set_error(err, errlen, MMR_CORRUPT, "zstd reserved header bit set");
  if (!single) {
    NEED(1);
    p++;
  }
  static const int did_size[4] = {0, 1, 2, 4}, fcs_size[4] = {0, 2, 4, 8};
  int ds = did_size[fhd & 3];
  NEED((size_t)ds);
  uint32_t did = 0;
  for (int i = 0; i < ds; i++) did |= (uint32_t)src[p + i] << (8 * i);
  p += ds;
  if (did != 0)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED,
                         "zstd dictionary ID %u (this decoder takes frames without "
                         "a dictionary)",
                         did);
  int fs = fcs_flag == 0 ? single : fcs_size[fcs_flag];
  NEED((size_t)fs);
  uint64_t fcs = 0;
  for (int i = 0; i < fs; i++) fcs |= (uint64_t)src[p + i] << (8 * i);
  if (fs == 2) fcs += 256;
  p += fs;
  z->rep[0] = 1;
  z->rep[1] = 4;
  z->rep[2] = 8;
  z->huf.valid = z->ll.valid = z->of.valid = z->ml.valid = 0;
  uint8_t *fstart = *opp, *op = *opp;
  for (;;) {
    NEED(3);
    uint32_t bh = src[p] | (uint32_t)src[p + 1] << 8 | (uint32_t)src[p + 2] << 16;
    p += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (type == 0) {
      NEED(bsize);
      if (bsize > (size_t)(oend - op))
        return mmr_set_error(err, errlen, MMR_CORRUPT, "zstd output exceeds %zu bytes",
                             (size_t)(oend - fstart));
      memcpy(op, src + p, bsize);
      op += bsize;
      p += bsize;
    } else if (type == 1) {
      NEED(1);
      if (bsize > (size_t)(oend - op))
        return mmr_set_error(err, errlen, MMR_CORRUPT, "zstd output exceeds %zu bytes",
                             (size_t)(oend - fstart));
      memset(op, src[p], bsize);
      op += bsize;
      p += 1;
    } else if (type == 2) {
      NEED(bsize);
      if (bsize > BLOCK_MAX || block(z, src + p, bsize, fstart, &op, oend))
        return mmr_set_error(err, errlen, MMR_CORRUPT,
                             "corrupt zstd compressed block at byte %zu", p - 3);
      p += bsize;
    } else {
      return mmr_set_error(err, errlen, MMR_CORRUPT, "zstd reserved block type at byte %zu",
                           p - 3);
    }
    if (last) break;
  }
  if (checksum) {
    NEED(4);
    p += 4;
  }
#undef NEED
  if ((fcs_flag || single) && fcs != (uint64_t)(op - fstart))
    return mmr_set_error(err, errlen, MMR_CORRUPT,
                         "zstd frame gave %zu bytes, its header says %llu",
                         (size_t)(op - fstart), (unsigned long long)fcs);
  *in_used = p;
  *opp = op;
  return MMR_OK;
}

int mmr_zstd_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                        size_t *written, char *err, size_t errlen) {
  zctx *z = NULL;
  uint8_t *op = dst, *oend = dst + cap;
  size_t p = 0;
  int rc = MMR_OK;
  *written = 0;
  if (n == 0) return mmr_set_error(err, errlen, MMR_CORRUPT, "empty zstd input");
  while (p < n) {
    if (n - p < 4) {
      rc = mmr_set_error(err, errlen, MMR_CORRUPT, "zstd input truncated at byte %zu", p);
      break;
    }
    uint32_t magic = le32(src + p);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) { /* skippable frame */
      if (n - p < 8 || le32(src + p + 4) > n - p - 8) {
        rc = mmr_set_error(err, errlen, MMR_CORRUPT, "truncated zstd skippable frame");
        break;
      }
      p += 8 + (size_t)le32(src + p + 4);
      continue;
    }
    if (magic != ZSTD_MAGIC) {
      rc = mmr_set_error(err, errlen, MMR_CORRUPT,
                         "not a zstd frame at byte %zu (magic 0x%08x)", p, magic);
      break;
    }
    if (!z && !(z = malloc(sizeof(zctx)))) {
      rc = mmr_set_error(err, errlen, MMR_NOMEM, "out of memory");
      break;
    }
    size_t used = 0;
    rc = frame(z, src + p, n - p, &used, oend, &op, err, errlen);
    if (rc != MMR_OK) break;
    p += used;
  }
  free(z);
  *written = (size_t)(op - dst);
  return rc;
}
