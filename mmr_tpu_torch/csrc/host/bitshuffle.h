/* c-blosc's bitshuffle and its inverse, on 64-bit words.
 *
 * A block of n elements of ts bytes (n a multiple of 8) is stored as
 * 8 * ts rows of n / 8 bytes: row (8 j + b) holds bit b of byte j of
 * every element, element i at bit i % 8 of byte i / 8. Both directions
 * move 64 elements at a time in 64-bit words: 8 x 8 byte transposes
 * between the elements and byte planes, 8 x 8 bit transposes across eight
 * words between the byte planes and the rows. Elements past the last 64,
 * and any ts other than 1, 2, 4 and 8, go 8 at a time. */
#ifndef MMR_BITSHUFFLE_H
#define MMR_BITSHUFFLE_H

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define BS_INLINE static inline __attribute__((always_inline))

BS_INLINE uint64_t bs_rd64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

BS_INLINE void bs_wr64(uint8_t *p, uint64_t v) { memcpy(p, &v, 8); }

/* an 8x8 bit matrix (byte r, bit c) transposed to (byte c, bit r) */
BS_INLINE uint64_t bs_transpose_bits(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x = x ^ t ^ (t << 28);
  return x;
}

/* x[i] byte k <-> x[k] byte i */
BS_INLINE void bs_transpose_bytes(uint64_t *x) {
  for (int i = 0; i < 8; i += 2) {
    uint64_t t = ((x[i] >> 8) ^ x[i + 1]) & 0x00FF00FF00FF00FFull;
    x[i + 1] ^= t;
    x[i] ^= t << 8;
  }
  for (int i = 0; i < 8; i += (i & 1) ? 3 : 1) {
    uint64_t t = ((x[i] >> 16) ^ x[i + 2]) & 0x0000FFFF0000FFFFull;
    x[i + 2] ^= t;
    x[i] ^= t << 16;
  }
  for (int i = 0; i < 4; i++) {
    uint64_t t = ((x[i] >> 32) ^ x[i + 4]) & 0x00000000FFFFFFFFull;
    x[i + 4] ^= t;
    x[i] ^= t << 32;
  }
}

/* w[b] bit i <-> w[i % 8] bit (8 (i / 8) + b): each 8 x 8 block of bits
 * (rows the eight words, columns one byte of them) transposed in place */
BS_INLINE void bs_transpose_rows(uint64_t *w) {
  for (int i = 0; i < 8; i += 2) {
    uint64_t t = ((w[i] >> 1) ^ w[i + 1]) & 0x5555555555555555ull;
    w[i + 1] ^= t;
    w[i] ^= t << 1;
  }
  for (int i = 0; i < 8; i += (i & 1) ? 3 : 1) {
    uint64_t t = ((w[i] >> 2) ^ w[i + 2]) & 0x3333333333333333ull;
    w[i + 2] ^= t;
    w[i] ^= t << 2;
  }
  for (int i = 0; i < 4; i++) {
    uint64_t t = ((w[i] >> 4) ^ w[i + 4]) & 0x0F0F0F0F0F0F0F0Full;
    w[i + 4] ^= t;
    w[i] ^= t << 4;
  }
}

/* Elements e0 .. e0 + 63 of src into the rows of dst (row = n / 8 bytes;
 * ts 1, 2, 4 or 8). w[j][r] byte m is byte j of element e0 + 8 m + r:
 * built by byte transposes of eight 8-byte loads (8 / ts elements each),
 * then each w[j]'s bit blocks transposed into the rows of byte j. */
BS_INLINE void bs_shuffle64(const uint8_t *src, uint8_t *dst, size_t row, size_t e0, size_t ts) {
  uint64_t w[8][8];
  size_t per = 8 / ts;
  for (size_t r0 = 0; r0 < 8; r0 += per) {
    uint64_t z[8];
    for (int m = 0; m < 8; m++) z[m] = bs_rd64(src + ts * (e0 + 8 * m + r0));
    bs_transpose_bytes(z);
    for (size_t q = 0; q < per; q++)
      for (size_t j = 0; j < ts; j++) w[j][r0 + q] = z[q * ts + j];
  }
  for (size_t j = 0; j < ts; j++) {
    bs_transpose_rows(w[j]);
    for (int b = 0; b < 8; b++) bs_wr64(dst + (8 * j + b) * row + e0 / 8, w[j][b]);
  }
}

/* the inverse: elements e0 .. e0 + 63 of dst from the rows of src */
BS_INLINE void bs_unshuffle64(const uint8_t *src, uint8_t *dst, size_t row, size_t e0,
                              size_t ts) {
  uint64_t w[8][8];
  size_t per = 8 / ts;
  for (size_t j = 0; j < ts; j++) {
    for (int b = 0; b < 8; b++) w[j][b] = bs_rd64(src + (8 * j + b) * row + e0 / 8);
    bs_transpose_rows(w[j]);
  }
  for (size_t r0 = 0; r0 < 8; r0 += per) {
    uint64_t z[8];
    for (size_t q = 0; q < per; q++)
      for (size_t j = 0; j < ts; j++) z[q * ts + j] = w[j][r0 + q];
    bs_transpose_bytes(z);
    for (int m = 0; m < 8; m++) bs_wr64(dst + ts * (e0 + 8 * m + r0), z[m]);
  }
}

/* 8 elements e0 .. e0 + 7, any ts */
static inline void bs_shuffle8(const uint8_t *src, uint8_t *dst, size_t row, size_t e0,
                               size_t ts) {
  for (size_t j = 0; j < ts; j++) {
    uint64_t x = 0;
    for (int r = 0; r < 8; r++) x |= (uint64_t)src[(e0 + r) * ts + j] << (8 * r);
    x = bs_transpose_bits(x);
    for (int b = 0; b < 8; b++) dst[(8 * j + b) * row + e0 / 8] = (uint8_t)(x >> (8 * b));
  }
}

static inline void bs_unshuffle8(const uint8_t *src, uint8_t *dst, size_t row, size_t e0,
                                 size_t ts) {
  for (size_t j = 0; j < ts; j++) {
    uint64_t x = 0;
    for (int b = 0; b < 8; b++) x |= (uint64_t)src[(8 * j + b) * row + e0 / 8] << (8 * b);
    x = bs_transpose_bits(x);
    for (int r = 0; r < 8; r++) dst[(e0 + r) * ts + j] = (uint8_t)(x >> (8 * r));
  }
}

#define BS_DISPATCH(fn64, fn8, src, dst, row, n, ts)                                    \
  do {                                                                                 \
    size_t e_ = 0;                                                                     \
    switch (ts) {                                                                      \
      case 1:                                                                          \
        for (; e_ + 64 <= (n); e_ += 64) fn64(src, dst, row, e_, 1);                   \
        break;                                                                         \
      case 2:                                                                          \
        for (; e_ + 64 <= (n); e_ += 64) fn64(src, dst, row, e_, 2);                   \
        break;                                                                         \
      case 4:                                                                          \
        for (; e_ + 64 <= (n); e_ += 64) fn64(src, dst, row, e_, 4);                   \
        break;                                                                         \
      case 8:                                                                          \
        for (; e_ + 64 <= (n); e_ += 64) fn64(src, dst, row, e_, 8);                   \
        break;                                                                         \
    }                                                                                  \
    for (; e_ < (n); e_ += 8) fn8(src, dst, row, e_, ts);                              \
  } while (0)

/* c-blosc's bitshuffle of one block of bsize bytes: a block of n = bsize
 * / ts elements with n % 8 == 0 is transposed (bytes past its last whole
 * element copied), any other block copied as it is */
static inline void bitshuffle_block(size_t ts, size_t bsize, const uint8_t *src, uint8_t *dst) {
  size_t n = bsize / ts;
  if (n % 8) {
    memcpy(dst, src, bsize);
    return;
  }
  BS_DISPATCH(bs_shuffle64, bs_shuffle8, src, dst, n / 8, n, ts);
  memcpy(dst + n * ts, src + n * ts, bsize - n * ts);
}

static inline void bitunshuffle_block(size_t ts, size_t bsize, const uint8_t *src,
                                      uint8_t *dst) {
  size_t n = bsize / ts;
  if (n % 8) {
    memcpy(dst, src, bsize);
    return;
  }
  BS_DISPATCH(bs_unshuffle64, bs_unshuffle8, src, dst, n / 8, n, ts);
  memcpy(dst + n * ts, src + n * ts, bsize - n * ts);
}

#endif
