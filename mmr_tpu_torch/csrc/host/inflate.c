/* zlib streams (RFC 1950) of deflate blocks (RFC 1951), as c-blosc's zlib
 * codec writes each block stream with compress2: the 2-byte header (method
 * 8, a window of at most 32 KiB, no preset dictionary), stored, fixed and
 * dynamic Huffman blocks, and the Adler-32 of the output after the last
 * block, which is checked. Bytes after the stream are ignored, as zlib's
 * uncompress ignores them.
 *
 * Codes are read LSB first from a 64-bit bit buffer; each Huffman table
 * answers codes of up to FAST bits with one lookup and longer ones code
 * length by code length, over the counts of canonical codes (zlib's puff.c).
 * A code set that is over-subscribed, or incomplete with more than one
 * code, is refused as zlib refuses it. */
#include <string.h>

#include "mmr_host.h"

#define FAST 10
#define MAXBITS 15

typedef struct {
  uint16_t fast[1 << FAST]; /* symbol << 4 | length, 0 where the code is longer */
  uint16_t count[MAXBITS + 1], symbol[288];
} huff;

typedef struct {
  const uint8_t *p, *end;
  uint64_t buf;
  int cnt, pad; /* bits in buf; how many of them are zeros past the end */
  uint8_t *out, *op, *oend;
  char *err;
  size_t errlen;
} inflater;

#define IFAIL(...) return mmr_set_error(s->err, s->errlen, MMR_CORRUPT, __VA_ARGS__)

static inline void refill(inflater *s) {
  while (s->cnt <= 56) {
    uint64_t b = 0;
    if (s->p < s->end)
      b = *s->p++;
    else
      s->pad += 8;
    s->buf |= b << s->cnt;
    s->cnt += 8;
  }
}

/* n bits (n <= 32); *bad set when they reach past the stream's end */
static inline uint32_t bits(inflater *s, int n, int *bad) {
  if (s->cnt < n) refill(s);
  uint32_t v = (uint32_t)(s->buf & ((1ull << n) - 1));
  s->buf >>= n;
  s->cnt -= n;
  if (s->cnt < s->pad) *bad = 1;
  return v;
}

/* the canonical code of lengths[0 .. n): -1 over-subscribed or incomplete
 * with more than one code */
static int build(huff *h, const uint8_t *lengths, int n) {
  uint16_t offs[MAXBITS + 2];
  memset(h->count, 0, sizeof h->count);
  memset(h->fast, 0, sizeof h->fast);
  for (int i = 0; i < n; i++) h->count[lengths[i]]++;
  if (h->count[0] == n) return 0; /* no codes: any use is an error */
  int left = 1, max = 0;
  for (int len = 1; len <= MAXBITS; len++) {
    left = (left << 1) - h->count[len];
    if (left < 0) return -1;
    if (h->count[len]) max = len;
  }
  if (left > 0 && max != 1) return -1;
  offs[1] = 0;
  for (int len = 1; len <= MAXBITS; len++) offs[len + 1] = offs[len] + h->count[len];
  for (int i = 0; i < n; i++)
    if (lengths[i]) h->symbol[offs[lengths[i]]++] = (uint16_t)i;
  /* the lookup: each code of up to FAST bits, bit-reversed, at every index
   * whose low bits it is */
  int code = 0, idx = 0;
  for (int len = 1; len <= FAST; len++) {
    for (int k = 0; k < h->count[len]; k++, idx++, code++) {
      int rev = 0;
      for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int i = rev; i < (1 << FAST); i += 1 << len)
        h->fast[i] = (uint16_t)(h->symbol[idx] << 4 | len);
    }
    code <<= 1;
  }
  return 0;
}

/* one symbol; -1 for a code outside the set */
static inline int decode(inflater *s, const huff *h, int *bad) {
  if (s->cnt < MAXBITS) refill(s);
  unsigned e = h->fast[s->buf & ((1 << FAST) - 1)];
  if (e) {
    s->buf >>= e & 15;
    s->cnt -= e & 15;
    if (s->cnt < s->pad) *bad = 1;
    return (int)(e >> 4);
  }
  uint64_t b = s->buf;
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= MAXBITS; len++) {
    code |= (int)(b & 1);
    b >>= 1;
    int count = h->count[len];
    if (code - count < first) {
      s->buf >>= len;
      s->cnt -= len;
      if (s->cnt < s->pad) *bad = 1;
      return h->symbol[index + (code - first)];
    }
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  return -1;
}

static const uint16_t LBASE[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                   31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t LEXT[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t DBASE[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                   33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                   1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
static const uint8_t DEXT[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

static int codes(inflater *s, const huff *lit, const huff *dist) {
  int bad = 0;
  for (;;) {
    int sym = decode(s, lit, &bad);
    if (sym < 0 || bad) IFAIL("corrupt deflate literal/length code at output byte %zu", (size_t)(s->op - s->out));
    if (sym < 256) {
      if (s->op >= s->oend) IFAIL("deflate stream longer than its %zu-byte output", (size_t)(s->oend - s->out));
      *s->op++ = (uint8_t)sym;
      continue;
    }
    if (sym == 256) return MMR_OK;
    sym -= 257;
    if (sym >= 29) IFAIL("deflate length code %d", sym + 257);
    size_t len = LBASE[sym] + bits(s, LEXT[sym], &bad);
    int ds = decode(s, dist, &bad);
    if (ds < 0 || ds >= 30 || bad) IFAIL("corrupt deflate distance code at output byte %zu", (size_t)(s->op - s->out));
    size_t d = DBASE[ds] + bits(s, DEXT[ds], &bad);
    if (bad) IFAIL("truncated deflate stream");
    if (d > (size_t)(s->op - s->out) || len > (size_t)(s->oend - s->op))
      IFAIL("deflate match of %zu bytes at distance %zu, %zu bytes out of %zu", len, d,
            (size_t)(s->op - s->out), (size_t)(s->oend - s->out));
    uint8_t *op = s->op;
    const uint8_t *ref = op - d;
    if (d >= len) {
      memcpy(op, ref, len);
    } else {
      for (size_t i = 0; i < len; i++) op[i] = ref[i];
    }
    s->op += len;
  }
}

static const uint8_t ORDER[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

static int dynamic(inflater *s, huff *lit, huff *dist) {
  int bad = 0;
  int nlen = (int)bits(s, 5, &bad) + 257, ndist = (int)bits(s, 5, &bad) + 1,
      ncode = (int)bits(s, 4, &bad) + 4;
  if (nlen > 286 || ndist > 30) IFAIL("deflate block of %d length and %d distance codes", nlen, ndist);
  uint8_t lengths[320] = {0};
  for (int i = 0; i < ncode; i++) lengths[ORDER[i]] = (uint8_t)bits(s, 3, &bad);
  huff lencode;
  if (bad || build(&lencode, lengths, 19)) IFAIL("corrupt deflate code-length code");
  for (int i = 0; i < nlen + ndist;) {
    int sym = decode(s, &lencode, &bad), rep = 0, len = 0;
    if (sym < 0 || bad) IFAIL("corrupt deflate code lengths");
    if (sym < 16) {
      lengths[i++] = (uint8_t)sym;
      continue;
    }
    if (sym == 16) {
      if (i == 0) IFAIL("deflate repeat of no code length");
      len = lengths[i - 1];
      rep = 3 + (int)bits(s, 2, &bad);
    } else if (sym == 17) {
      rep = 3 + (int)bits(s, 3, &bad);
    } else {
      rep = 11 + (int)bits(s, 7, &bad);
    }
    if (i + rep > nlen + ndist) IFAIL("deflate code lengths past their count");
    while (rep--) lengths[i++] = (uint8_t)len;
  }
  if (lengths[256] == 0) IFAIL("deflate block without an end-of-block code");
  if (build(lit, lengths, nlen) || build(dist, lengths + nlen, ndist))
    IFAIL("corrupt deflate literal/length or distance code");
  return MMR_OK;
}

static void fixed(huff *lit, huff *dist) {
  uint8_t lengths[288];
  for (int i = 0; i < 288; i++) lengths[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
  build(lit, lengths, 288);
  for (int i = 0; i < 32; i++) lengths[i] = 5; /* 30 and 31 are codes, not distances */
  build(dist, lengths, 32);
}

static uint32_t adler32(const uint8_t *p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = n < 5552 ? n : 5552;
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return b << 16 | a;
}

int mmr_zlib_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                        size_t *written, char *err, size_t errlen) {
  *written = 0;
  if (n < 2) return mmr_set_error(err, errlen, MMR_CORRUPT, "zlib stream of %zu bytes", n);
  int cmf = src[0], flg = src[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf << 8 | flg) % 31)
    return mmr_set_error(err, errlen, MMR_CORRUPT, "not a zlib stream (header 0x%02X%02X)", cmf, flg);
  if (flg & 0x20)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED, "zlib stream with a preset dictionary");
  inflater st = {src + 2, src + n, 0, 0, 0, dst, dst, dst + cap, err, errlen}, *s = &st;
  huff lit, dist;
  int last, bad = 0;
  do {
    last = (int)bits(s, 1, &bad);
    int type = (int)bits(s, 2, &bad), rc = MMR_OK;
    if (bad) IFAIL("truncated deflate stream");
    if (type == 0) {
      bits(s, s->cnt & 7, &bad); /* to the byte boundary */
      size_t len = bits(s, 16, &bad), nlen = bits(s, 16, &bad);
      if (bad || len != (~nlen & 0xFFFF)) IFAIL("corrupt stored deflate block");
      if (len > (size_t)(s->oend - s->op)) IFAIL("deflate stream longer than its %zu-byte output", cap);
      for (; len && s->cnt; len--) *s->op++ = (uint8_t)bits(s, 8, &bad);
      if (bad || len > (size_t)(s->end - s->p)) IFAIL("truncated stored deflate block");
      memcpy(s->op, s->p, len);
      s->op += len;
      s->p += len;
    } else if (type == 1) {
      fixed(&lit, &dist);
      rc = codes(s, &lit, &dist);
    } else if (type == 2) {
      rc = dynamic(s, &lit, &dist);
      if (rc == MMR_OK) rc = codes(s, &lit, &dist);
    } else {
      IFAIL("deflate block type 3");
    }
    if (rc != MMR_OK) return rc;
  } while (!last);
  bits(s, s->cnt & 7, &bad);
  uint32_t want = 0;
  for (int i = 0; i < 4; i++) want = want << 8 | bits(s, 8, &bad);
  if (bad) IFAIL("zlib stream without its Adler-32");
  uint32_t got = adler32(dst, (size_t)(s->op - dst));
  if (got != want) IFAIL("zlib Adler-32 %08X, the stream says %08X", got, want);
  *written = (size_t)(s->op - dst);
  return MMR_OK;
}
