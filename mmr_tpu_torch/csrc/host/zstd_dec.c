/* zstd decoder (RFC 8878): every frame of a buffer into one flat output.
 *
 * Blocks raw, RLE and compressed; literals raw, RLE, Huffman-coded in one
 * or four streams, and treeless (the frame's previous table); sequences
 * with FSE tables in predefined, RLE, compressed and repeat modes, the
 * three repeat offsets. The whole frame lands in the caller's buffer, so
 * a match may reach anywhere back to the frame's first byte and no window
 * buffer is kept. Skippable frames are skipped; content checksums are not
 * verified; a dictionary ID other than 0 is refused. Every read and write
 * is bounds-checked: damaged input gives MMR_CORRUPT.
 *
 * The hot paths are libzstd's: bitstreams read a 64-bit word at a time
 * (bitd), the four Huffman streams of a block decoded interleaved,
 * sequences read through cells that hold each code's base and extra bits,
 * and literals and matches copied 16 or 8 bytes at a time past their ends
 * wherever the output has WILD bytes of room (a short offset first spread
 * to 8 or more). */
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "mmr_host.h"

#define ZSTD_MAGIC 0xFD2FB528u
#define BLOCK_MAX (128 * 1024)
#define WILD 32 /* bytes a wild copy may write past its end */

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

/* The same stream read a word at a time: c holds the 8 bytes at p, `used`
 * bits of it are taken from the top. A refill steps p back by whole bytes
 * (never below the stream's start), so reads between refills need no
 * bounds branch; up to 56 bits can be read after each refill. Bits
 * remaining: (p - start) * 8 + 64 - used, below 0 once the reader went
 * past the start (what bitr's pos < 0 means). */
typedef struct {
  uint64_t c;
  unsigned used;
  const uint8_t *p, *start;
} bitd;

static inline uint64_t rd64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

static int bitd_init(bitd *b, const uint8_t *src, size_t n) {
  if (n == 0 || src[n - 1] == 0) return -1;
  b->start = src;
  b->used = 8 - (unsigned)highbit(src[n - 1]);
  if (n >= 8) {
    b->p = src + n - 8;
    b->c = rd64(b->p);
  } else {
    b->p = src;
    b->c = 0;
    memcpy(&b->c, src, n);
    b->used += (unsigned)(8 - n) * 8;
  }
  return 0;
}

/* nb <= 56 bits past the last refill. Bits below the start read as zero
 * while used < 64; past that the value is arbitrary but below 2^nb (so
 * every table index stays in its table), and only a damaged stream gets
 * there: its end check fails. */
static inline uint64_t bitd_peek(const bitd *b, unsigned nb) {
  return (b->c << (b->used & 63)) >> 1 >> (63 - nb);
}

static inline uint64_t bitd_read(bitd *b, unsigned nb) {
  uint64_t v = bitd_peek(b, nb);
  b->used += nb;
  return v;
}

static void bitd_refill_slow(bitd *b) {
  if (b->used > 64 || b->p == b->start) return; /* at or past the start: stays so */
  size_t k = b->used >> 3;
  if (k > (size_t)(b->p - b->start)) k = (size_t)(b->p - b->start);
  b->p -= k;
  b->used -= (unsigned)k * 8;
  b->c = rd64(b->p);
}

/* Reads between refills take at most 57 bits, so `used` <= 64 here
 * whenever p is 8 bytes or more from the start. */
static inline void bitd_refill(bitd *b) {
  if (__builtin_expect(b->p >= b->start + 8, 1)) {
    b->p -= b->used >> 3;
    b->used &= 7;
    b->c = rd64(b->p);
  } else {
    bitd_refill_slow(b);
  }
}

/* the stream read to its first bit, no further */
static inline int bitd_done(const bitd *b) { return b->p == b->start && b->used == 64; }

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

/* A sequence table's state: the code's base value and extra bits beside
 * the FSE transition, one lookup a field */
typedef struct {
  uint32_t base;
  uint16_t next;
  uint8_t nbits, add;
} seq_cell;

typedef struct {
  huf_t huf;
  fse_t ll, of, ml, tmp;
  seq_cell sll[512], sof[512], sml[512];
  uint64_t rep[3];
  uint8_t lit[BLOCK_MAX + WILD];
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

/* One stream: its cnt symbols into dst. Four symbols of at most 12 bits
 * a refill while the reader is 8 bytes or more from the start, then one
 * at a time. The stream must end on its first bit. */
static int huf_stream(const huf_t *h, const uint8_t *src, size_t n, uint8_t *dst,
                      size_t cnt) {
  bitd b;
  const huf_cell *t = h->c;
  const unsigned bits = (unsigned)h->bits;
  uint8_t *op = dst, *end = dst + cnt;
  if (bitd_init(&b, src, n)) return -1;
  while (end - op >= 4 && b.p >= b.start + 8) {
    bitd_refill(&b);
    for (int k = 0; k < 4; k++) {
      huf_cell c = t[bitd_peek(&b, bits)];
      *op++ = c.sym;
      b.used += c.nb;
    }
  }
  while (op < end) {
    bitd_refill(&b);
    huf_cell c = t[bitd_peek(&b, bits)];
    *op++ = c.sym;
    b.used += c.nb;
  }
  bitd_refill(&b);
  return bitd_done(&b) ? 0 : -1;
}

/* Four streams of one table, interleaved: cnt[k] symbols of stream k
 * into dst[k]. */
static int huf_streams4(const huf_t *h, const uint8_t *const src[4], const size_t n[4],
                        uint8_t *const dst[4], const size_t cnt[4]) {
  bitd b[4];
  const huf_cell *t = h->c;
  const unsigned bits = (unsigned)h->bits;
  uint8_t *op[4];
  size_t left = cnt[3];
  for (int k = 0; k < 4; k++) {
    if (bitd_init(&b[k], src[k], n[k])) return -1;
    op[k] = dst[k];
    if (cnt[k] < left) left = cnt[k];
  }
  for (;;) {
    if (left < 4) break;
    int ok = 1;
    for (int k = 0; k < 4; k++) ok &= b[k].p >= b[k].start + 8;
    if (!ok) break;
    for (int k = 0; k < 4; k++) bitd_refill(&b[k]);
    for (int j = 0; j < 4; j++)
      for (int k = 0; k < 4; k++) {
        huf_cell c = t[bitd_peek(&b[k], bits)];
        op[k][j] = c.sym;
        b[k].used += c.nb;
      }
    for (int k = 0; k < 4; k++) op[k] += 4;
    left -= 4;
  }
  for (int k = 0; k < 4; k++) {
    uint8_t *end = dst[k] + cnt[k];
    while (op[k] < end) {
      bitd_refill(&b[k]);
      huf_cell c = t[bitd_peek(&b[k], bits)];
      *op[k]++ = c.sym;
      b[k].used += c.nb;
    }
    bitd_refill(&b[k]);
    if (!bitd_done(&b[k])) return -1;
  }
  return 0;
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
    const uint8_t *q[4] = {p + 6, p + 6 + sz[0], p + 6 + sz[0] + sz[1],
                           p + 6 + sz[0] + sz[1] + sz[2]};
    uint8_t *const d[4] = {z->lit, z->lit + seg, z->lit + 2 * seg, z->lit + 3 * seg};
    const size_t cnt[4] = {seg, seg, seg, regen - 3 * seg};
    if (huf_streams4(&z->huf, q, sz, d, cnt)) return -1;
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

/* n bytes from src to dst 16 at a time: writes up to 15 bytes past
 * dst + n and reads as far past src + n */
static inline void wild_copy16(uint8_t *dst, const uint8_t *src, size_t n) {
  uint8_t *end = dst + n;
  while (dst < end) {
    memcpy(dst, src, 16);
    dst += 16;
    src += 16;
  }
}

/* A match of ml bytes at offset off (m = op - off). With `wild`, room for
 * WILD bytes past the match: 16- or 8-byte copies, a short offset first
 * spread to 8 or more as libzstd's ZSTD_overlapCopy8 does; else exact. */
static inline void copy_match(uint8_t *op, const uint8_t *m, size_t ml, size_t off, int wild) {
  if (wild && off >= 16) {
    memcpy(op, m, 16);
    if (ml > 16) wild_copy16(op + 16, m + 16, ml - 16);
    return;
  }
  if (off == 1) {
    memset(op, m[0], ml);
    return;
  }
  if (!wild) {
    if (off >= ml) {
      memcpy(op, m, ml);
    } else {
      for (size_t k = 0; k < ml; k++) op[k] = m[k];
    }
    return;
  }
  uint8_t *end = op + ml;
  if (off < 8) {
    static const uint8_t inc[8] = {0, 1, 2, 1, 4, 4, 4, 4};
    static const uint8_t dec[8] = {8, 8, 8, 7, 8, 9, 10, 11};
    op[0] = m[0];
    op[1] = m[1];
    op[2] = m[2];
    op[3] = m[3];
    m += inc[off];
    memcpy(op + 4, m, 4);
    m += 8 - (ptrdiff_t)dec[off];
  } else {
    memcpy(op, m, 8);
    m += 8;
  }
  op += 8;
  while (op < end) { /* op - m >= 8 now */
    memcpy(op, m, 8);
    op += 8;
    m += 8;
  }
}

/* The sequence cells of an FSE table whose symbols are codes with the
 * given base values and extra bits (offsets: base 1 << code, code bits).
 * Every symbol a table holds is a valid code: seq_table admits no other. */
static void seq_cells(seq_cell *out, const fse_t *t, const uint32_t *base, const uint8_t *bits) {
  for (int u = 0, size = 1 << t->log; u < size; u++) {
    int sym = t->c[u].sym;
    out[u].base = base ? base[sym] : 1u << sym;
    out[u].add = bits ? bits[sym] : (uint8_t)sym;
    out[u].next = t->c[u].base;
    out[u].nbits = t->c[u].nb;
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
    bitd b;
    if (p > end || bitd_init(&b, p, end - p)) return -1;
    seq_cells(z->sll, &z->ll, LL_BASE, LL_BITS);
    seq_cells(z->sof, &z->of, NULL, NULL);
    seq_cells(z->sml, &z->ml, ML_BASE, ML_BITS);
    const seq_cell *sl = z->sll, *so = z->sof, *sm = z->sml;
    /* where a wild copy of literals may read to: the literals buffer's
     * slack, or the block's end for literals stored raw in it */
    const uint8_t *lsafe = lit == z->lit ? z->lit + sizeof z->lit : end;
    uint32_t lls = (uint32_t)bitd_read(&b, (unsigned)z->ll.log);
    uint32_t ofs = (uint32_t)bitd_read(&b, (unsigned)z->of.log);
    uint32_t mls = (uint32_t)bitd_read(&b, (unsigned)z->ml.log);
    uint64_t *rep = z->rep;
    for (size_t i = 0; i < nseq; i++) {
      const seq_cell L = sl[lls], O = so[ofs], M = sm[mls];
      /* one refill a sequence (libzstd's order): 57 bits take the offset's
       * and the lengths' extra bits and the states' 26 while those extra
       * bits are under 31; else a second refill after the offset's and
       * the match length's */
      bitd_refill(&b);
      uint64_t off, ofv = O.base + bitd_read(&b, O.add);
      uint64_t ml = M.base + bitd_read(&b, M.add);
      if (O.add + M.add + L.add >= 31) bitd_refill(&b);
      uint64_t ll = L.base + bitd_read(&b, L.add);
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
        lls = L.next + (uint32_t)bitd_read(&b, L.nbits);
        mls = M.next + (uint32_t)bitd_read(&b, M.nbits);
        ofs = O.next + (uint32_t)bitd_read(&b, O.nbits);
      }
      if (ll > (uint64_t)(lend - lit) || ll + ml > (uint64_t)(oend - op)) return -1;
      int wild = ll + ml + WILD <= (uint64_t)(oend - op);
      if (wild && ll + WILD <= (uint64_t)(lsafe - lit)) {
        memcpy(op, lit, 16);
        if (ll > 16) wild_copy16(op + 16, lit + 16, ll - 16);
      } else {
        memcpy(op, lit, ll);
      }
      op += ll;
      lit += ll;
      if (off == 0 || off > (uint64_t)(op - fstart)) return -1;
      copy_match(op, op - off, ml, off, wild);
      op += ml;
    }
    bitd_refill(&b);
    if (!bitd_done(&b)) return -1;
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
