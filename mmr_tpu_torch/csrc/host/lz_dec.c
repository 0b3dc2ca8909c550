/* The byte-oriented LZ77 streams of c-blosc 1.x's other compressors, each
 * a block stream as c-blosc hands it to its codec (blosc_dec.c splits the
 * chunk into them):
 *
 *   blosclz  c-blosc's FastLZ derivative (blosclz.c): a first literal run
 *            whose control byte's top 3 bits are ignored; then control
 *            bytes: below 32, a run of ctrl + 1 literals; else a match of
 *            (ctrl >> 5) + 2 bytes (7: 9 plus extension bytes while they
 *            are 255), at distance ((ctrl & 31) << 8) + next byte + 1, or,
 *            where both are at their maximum, a 16-bit big-endian distance
 *            plus 8192;
 *   lz4      the LZ4 block format (lz4 and lz4hc write the same): a token of
 *            4-bit literal and match lengths (15: extension bytes), the
 *            literals, a 16-bit little-endian offset and the match, 4 bytes
 *            or more; the last sequence is literals alone;
 *   snappy   a varint of the output size, then tagged elements: literals
 *            (lengths to 60 in the tag, else in 1 to 4 bytes) and copies
 *            with 1-, 2- or 4-byte offsets.
 *
 * Each fills dst[0 .. cap) at most and sets *written; a match that reaches
 * before the output's start or past its end, or a stream that ends inside
 * an element, is MMR_CORRUPT. */
#include <string.h>

#include "mmr_host.h"

#define BLOSCLZ_MAX_DISTANCE 8191

/* n bytes from op - dist to op; the ranges may overlap (dist < n), in
 * which case the dist bytes before op repeat */
static inline void lz_copy(uint8_t *op, size_t dist, size_t n) {
  if (dist >= n) {
    memcpy(op, op - dist, n);
  } else if (dist == 1) {
    memset(op, op[-1], n);
  } else {
    /* the bytes from op - dist on repeat with period dist, so each copy may
     * take twice as many as the one before, from the same start */
    size_t step = dist;
    while (n) {
      size_t k = n < step ? n : step;
      memcpy(op, op - step, k);
      op += k;
      n -= k;
      step += k;
    }
  }
}

#define LZ_FAIL(...) return mmr_set_error(err, errlen, MMR_CORRUPT, __VA_ARGS__)

int mmr_blosclz_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                           size_t *written, char *err, size_t errlen) {
  const uint8_t *ip = src, *iend = src + n;
  uint8_t *op = dst, *oend = dst + cap;
  *written = 0;
  if (n == 0) LZ_FAIL("empty blosclz stream");
  size_t ctrl = *ip++ & 31;
  for (;;) {
    if (ctrl >= 32) {
      size_t len = (ctrl >> 5) - 1, dist = (ctrl & 31) << 8, code;
      if (len == 6) do {
          if (ip >= iend) LZ_FAIL("truncated blosclz match length");
          code = *ip++;
          len += code;
        } while (code == 255);
      if (ip >= iend) LZ_FAIL("truncated blosclz match distance");
      code = *ip++;
      len += 3;
      dist += code + 1;
      if (code == 255 && dist == (31u << 8) + 256) {
        if (iend - ip < 2) LZ_FAIL("truncated blosclz far distance");
        dist = ((size_t)ip[0] << 8 | ip[1]) + BLOSCLZ_MAX_DISTANCE + 1;
        ip += 2;
      }
      if (dist > (size_t)(op - dst) || len > (size_t)(oend - op))
        LZ_FAIL("blosclz match of %zu bytes at distance %zu, %zu bytes out of %zu", len, dist,
                (size_t)(op - dst), cap);
      lz_copy(op, dist, len);
      op += len;
    } else {
      size_t len = ctrl + 1;
      if (len > (size_t)(iend - ip) || len > (size_t)(oend - op))
        LZ_FAIL("blosclz literal run of %zu bytes past the stream or the output", len);
      memcpy(op, ip, len);
      op += len;
      ip += len;
    }
    if (ip >= iend) break;
    ctrl = *ip++;
  }
  *written = (size_t)(op - dst);
  return MMR_OK;
}

/* an LZ4 length: the token's 4 bits, and while they and each byte after
 * them are at their maximum, the next byte added */
static inline int lz4_length(const uint8_t **ip, const uint8_t *iend, size_t *len) {
  if (*len != 15) return 0;
  unsigned b;
  do {
    if (*ip >= iend) return -1;
    b = *(*ip)++;
    *len += b;
  } while (b == 255);
  return 0;
}

int mmr_lz4_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                       size_t *written, char *err, size_t errlen) {
  const uint8_t *ip = src, *iend = src + n;
  uint8_t *op = dst, *oend = dst + cap;
  *written = 0;
  for (;;) {
    if (ip >= iend) LZ_FAIL("truncated lz4 stream: a sequence without its literals");
    unsigned token = *ip++;
    size_t lit = token >> 4, len = token & 15;
    if (lz4_length(&ip, iend, &lit) || lit > (size_t)(iend - ip) ||
        lit > (size_t)(oend - op))
      LZ_FAIL("lz4 literal run of %zu bytes past the stream or the output", lit);
    memcpy(op, ip, lit);
    op += lit;
    ip += lit;
    if (ip == iend) break;
    if (iend - ip < 2) LZ_FAIL("truncated lz4 match offset");
    size_t dist = ip[0] | (size_t)ip[1] << 8;
    ip += 2;
    if (lz4_length(&ip, iend, &len)) LZ_FAIL("truncated lz4 match length");
    len += 4;
    if (dist == 0 || dist > (size_t)(op - dst) || len > (size_t)(oend - op))
      LZ_FAIL("lz4 match of %zu bytes at offset %zu, %zu bytes out of %zu", len, dist,
              (size_t)(op - dst), cap);
    lz_copy(op, dist, len);
    op += len;
  }
  *written = (size_t)(op - dst);
  return MMR_OK;
}

static inline size_t le_bytes(const uint8_t *p, int k) {
  size_t v = 0;
  for (int i = 0; i < k; i++) v |= (size_t)p[i] << (8 * i);
  return v;
}

int mmr_snappy_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                          size_t *written, char *err, size_t errlen) {
  const uint8_t *ip = src, *iend = src + n;
  uint8_t *op = dst;
  size_t size = 0;
  *written = 0;
  for (int shift = 0;; shift += 7) {
    if (ip >= iend || shift > 28) LZ_FAIL("snappy stream without its length");
    unsigned b = *ip++;
    size |= (size_t)(b & 127) << shift;
    if (b < 128) break;
  }
  if (size > cap) LZ_FAIL("snappy stream of %zu bytes, the output holds %zu", size, cap);
  uint8_t *oend = dst + size;
  while (ip < iend) {
    unsigned tag = *ip++;
    size_t len, dist;
    if ((tag & 3) == 0) {
      len = tag >> 2;
      if (len >= 60) {
        int k = (int)len - 59;
        if (iend - ip < k) LZ_FAIL("truncated snappy literal length");
        len = le_bytes(ip, k);
        ip += k;
      }
      len += 1;
      if (len > (size_t)(iend - ip) || len > (size_t)(oend - op))
        LZ_FAIL("snappy literal run of %zu bytes past the stream or the output", len);
      memcpy(op, ip, len);
      op += len;
      ip += len;
      continue;
    }
    int k = (tag & 3) == 1 ? 1 : (tag & 3) == 2 ? 2 : 4;
    if (iend - ip < k) LZ_FAIL("truncated snappy copy");
    if (k == 1) {
      len = ((tag >> 2) & 7) + 4;
      dist = (size_t)(tag >> 5) << 8 | ip[0];
    } else {
      len = (tag >> 2) + 1;
      dist = le_bytes(ip, k);
    }
    ip += k;
    if (dist == 0 || dist > (size_t)(op - dst) || len > (size_t)(oend - op))
      LZ_FAIL("snappy copy of %zu bytes at offset %zu, %zu bytes out of %zu", len, dist,
              (size_t)(op - dst), size);
    lz_copy(op, dist, len);
    op += len;
  }
  if (op != oend) LZ_FAIL("snappy stream gave %zu bytes, its header says %zu", (size_t)(op - dst), size);
  *written = size;
  return MMR_OK;
}
