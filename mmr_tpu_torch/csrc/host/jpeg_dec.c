/* Baseline and extended-Huffman 8-bit JPEG (SOF0, SOF1), decoded as
 * libjpeg-turbo does by default, so that the samples equal its own:
 *
 *   - Huffman tables (DHT) and quantization tables (DQT) as they stand
 *     when each scan starts (redefined between scans), restart intervals
 *     (DRI, RSTn), interleaved and single-component scans;
 *   - Motion-JPEG frames without DHT take the standard tables of the JPEG
 *     standard's Annex K for slots 0 and 1 (libjpeg-turbo's jstdhuff.c);
 *   - the ISLOW integer IDCT (jidctint.c: 13-bit constants, 2 pass bits)
 *     and its range limit;
 *   - 1 or 3 components; chroma at 4:4:4, 4:2:2 (h2v1) or 4:2:0 (h2v2),
 *     upsampled by libjpeg's "fancy" triangular filter (jdsample.c), the
 *     edge rows and columns repeated, a box filter where a component is
 *     at most 2 samples wide; or, on request, each chroma sample repeated
 *     over the 2x1 or 2x2 pixels it covers, which is how OpenCV's FFmpeg
 *     backend gives Motion-JPEG frames (cv2.VideoCapture);
 *   - its fixed-point YCbCr -> RGB (jdcolor.c, 16 fraction bits); three
 *     components tagged RGB (Adobe transform 0, or ids 'R' 'G' 'B' with
 *     no JFIF marker) are copied.
 *
 * Progressive, lossless, hierarchical, arithmetic-coded and 12-bit JPEG,
 * CMYK, DNL heights and other sampling factors give MMR_UNSUPPORTED,
 * naming what was found. */
#include <stdlib.h>
#include <string.h>

#include "mmr_host.h"

static const uint8_t ZZ[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18,
                               11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                               13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                               36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                               38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* Annex K.3: bits[1..16] then values */
static const uint8_t STD_DC_L_BITS[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t STD_DC_C_BITS[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t STD_DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t STD_AC_L_BITS[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t STD_AC_L_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t STD_AC_C_BITS[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t STD_AC_C_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
  uint8_t bits[17], vals[256];
  int defined, nsym;
  int32_t maxcode[18], valoff[18];
  uint8_t look_nb[256], look_sym[256];
} htab;

typedef struct {
  int id, h, v, tq, td, ta;
  int dw, dh;     /* samples of the component inside the image */
  int stride, bh; /* plane: stride = blocks across x 8, bh blocks down */
  uint8_t *plane;
  int dc_pred;
} comp_t;

typedef struct {
  const uint8_t *src;
  size_t n;
  uint16_t q[4][64];
  int qdef[4];
  htab dc[4], ac[4];
  int width, height, ncomp, hmax, vmax, mcux, mcuy, restart;
  int jfif, adobe, adobe_transform, sof;
  comp_t c[3];
  size_t cap; /* the output's bytes: a larger frame is refused before any allocation */
  int fancy;  /* chroma: libjpeg's triangular filter (1) or repeated samples (0) */
  char *err;
  size_t errlen;
} jdec;

#define FAIL(code, ...) return mmr_set_error(d->err, d->errlen, code, __VA_ARGS__)

/* ------------------------------------------------------------- Huffman */
static int derive(htab *t, int is_dc) {
  int size[257], code[257], p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < t->bits[l]; i++) {
      if (p >= 256) return -1;
      size[p++] = l;
    }
  size[p] = 0;
  t->nsym = p;
  int c = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) {
      code[p++] = c++;
    }
    if (c >= (1 << si)) return -1;
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t->bits[l]) {
      t->valoff[l] = p - code[p];
      p += t->bits[l];
      t->maxcode[l] = code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0xFFFFF;
  memset(t->look_nb, 0, sizeof t->look_nb);
  p = 0;
  for (int l = 1; l <= 8; l++)
    for (int i = 0; i < t->bits[l]; i++, p++) {
      int look = code[p] << (8 - l);
      for (int k = 1 << (8 - l); k > 0; k--, look++) {
        t->look_nb[look] = (uint8_t)l;
        t->look_sym[look] = t->vals[p];
      }
    }
  if (is_dc)
    for (int i = 0; i < t->nsym; i++)
      if (t->vals[i] > 15) return -1;
  return 0;
}

static void std_table(htab *t, const uint8_t *bits, const uint8_t *vals, int nvals) {
  memcpy(t->bits, bits, 17);
  memcpy(t->vals, vals, nvals);
  t->defined = 1;
}

/* the entropy-coded segment: 0xFF 0x00 is a 0xFF byte; a marker stops
 * the reader, which then feeds zero bits (libjpeg's rule) */
typedef struct {
  const uint8_t *p, *end;
  uint64_t acc;
  int nbits, marker;
} jbits;

static void jfill(jbits *b) {
  while (b->nbits <= 56) {
    int c = 0;
    if (!b->marker && b->p < b->end) {
      c = *b->p;
      if (c == 0xFF) {
        if (b->p + 1 < b->end && b->p[1] == 0) {
          b->p += 2;
        } else {
          b->marker = 1;
          c = 0;
        }
      } else {
        b->p++;
      }
    }
    b->acc = (b->acc << 8) | (uint64_t)c;
    b->nbits += 8;
  }
}

static inline int getbits(jbits *b, int n) {
  if (b->nbits < n) jfill(b);
  b->nbits -= n;
  return (int)(b->acc >> b->nbits) & ((1 << n) - 1);
}

static inline int hdecode(jbits *b, const htab *t) {
  if (b->nbits < 16) jfill(b);
  int look = (int)(b->acc >> (b->nbits - 8)) & 0xFF, nb = t->look_nb[look];
  if (nb) {
    b->nbits -= nb;
    return t->look_sym[look];
  }
  int l = 9;
  int32_t code = (int32_t)(b->acc >> (b->nbits - 9)) & 0x1FF;
  while (code > t->maxcode[l]) {
    if (++l > 16) return -1;
    code = (int32_t)(b->acc >> (b->nbits - l)) & ((1 << l) - 1);
  }
  b->nbits -= l;
  int idx = code + t->valoff[l];
  return idx >= 0 && idx < t->nsym ? t->vals[idx] : -1;
}

#define EXTEND(x, s) ((x) < (1 << ((s) - 1)) ? (x) + (int)(~0u << (s)) + 1 : (x))

static int decode_block(jbits *b, const htab *dc, const htab *ac, int *pred, int16_t *blk) {
  memset(blk, 0, 64 * sizeof *blk);
  int s = hdecode(b, dc);
  if (s < 0) return -1;
  if (s) {
    int r = getbits(b, s);
    *pred += EXTEND(r, s);
  }
  blk[0] = (int16_t)*pred;
  for (int k = 1; k < 64; k++) {
    int rs = hdecode(b, ac);
    if (rs < 0) return -1;
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) return -1;
      int v = getbits(b, s);
      blk[ZZ[k]] = (int16_t)EXTEND(v, s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return 0;
}

/* ----------------------------------------------------------- ISLOW IDCT */
#define CONST_BITS 13
#define PASS1_BITS 2
#define F_0_298 2446
#define F_0_390 3196
#define F_0_541 4433
#define F_0_765 6270
#define F_0_899 7373
#define F_1_175 9633
#define F_1_501 12299
#define F_1_847 15137
#define F_1_961 16069
#define F_2_053 16819
#define F_2_562 20995
#define F_3_072 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* libjpeg's post-IDCT range limit: the low 10 bits of the value, centred
 * on 128, clamped (values past +-512 wrap as its table does) */
static inline uint8_t range_limit(int64_t v) {
  int t = (int)(v & 1023);
  return t < 128 ? (uint8_t)(t + 128) : t < 512 ? 255 : t < 896 ? 0 : (uint8_t)(t - 896);
}

#define DQ(k) ((int64_t)ip[k] * qp[k])

static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *ip = in + c;
    const uint16_t *qp = q + c;
    int *wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (int)(DQ(0) * (1 << PASS1_BITS));
      for (int k = 0; k < 8; k++) wp[8 * k] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = DQ(16);
    z3 = DQ(48);
    z1 = (z2 + z3) * F_0_541;
    t2 = z1 + z3 * -F_1_847;
    t3 = z1 + z2 * F_0_765;
    z2 = DQ(0);
    z3 = DQ(32);
    t0 = (z2 + z3) * (1 << CONST_BITS);
    t1 = (z2 - z3) * (1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = DQ(56);
    t1 = DQ(40);
    t2 = DQ(24);
    t3 = DQ(8);
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F_1_175;
    t0 *= F_0_298;
    t1 *= F_2_053;
    t2 *= F_3_072;
    t3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    wp[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
    wp[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
    wp[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
    wp[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
    wp[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
    wp[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
    wp[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
    wp[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int *wp = ws + 8 * r;
    uint8_t *op = out + r * stride;
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * F_0_541;
    t2 = z1 + z3 * -F_1_847;
    t3 = z1 + z2 * F_0_765;
    t0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    t1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = wp[7];
    t1 = wp[5];
    t2 = wp[3];
    t3 = wp[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F_1_175;
    t0 *= F_0_298;
    t1 *= F_2_053;
    t2 *= F_3_072;
    t3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = range_limit(DESCALE(t10 + t3, sh));
    op[7] = range_limit(DESCALE(t10 - t3, sh));
    op[1] = range_limit(DESCALE(t11 + t2, sh));
    op[6] = range_limit(DESCALE(t11 - t2, sh));
    op[2] = range_limit(DESCALE(t12 + t1, sh));
    op[5] = range_limit(DESCALE(t12 - t1, sh));
    op[3] = range_limit(DESCALE(t13 + t0, sh));
    op[4] = range_limit(DESCALE(t13 - t0, sh));
  }
}

/* -------------------------------------------------------------- markers */
static const char *sof_name(int m) {
  switch (m) {
    case 0xC2: return "progressive JPEG (SOF2)";
    case 0xC3: return "lossless JPEG (SOF3)";
    case 0xC5: return "differential sequential JPEG (SOF5)";
    case 0xC6: return "differential progressive JPEG (SOF6)";
    case 0xC7: return "differential lossless JPEG (SOF7)";
    case 0xC9: return "arithmetic-coded sequential JPEG (SOF9)";
    case 0xCA: return "arithmetic-coded progressive JPEG (SOF10)";
    case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
    case 0xCD: return "differential arithmetic-coded sequential JPEG (SOF13)";
    case 0xCE: return "differential arithmetic-coded progressive JPEG (SOF14)";
    case 0xCF: return "differential arithmetic-coded lossless JPEG (SOF15)";
    default: return NULL;
  }
}

static inline int be16(const uint8_t *p) { return p[0] << 8 | p[1]; }

static int read_sof(jdec *d, const uint8_t *s, int len, int marker) {
  if (len < 6) FAIL(MMR_CORRUPT, "JPEG frame header of %d bytes", len);
  if (s[0] != 8)
    FAIL(MMR_UNSUPPORTED, "%d-bit JPEG (SOF%d; this decoder takes 8-bit samples)", s[0],
         marker - 0xC0);
  d->height = be16(s + 1);
  d->width = be16(s + 3);
  d->ncomp = s[5];
  if (d->height == 0)
    FAIL(MMR_UNSUPPORTED, "JPEG height given by a DNL marker (SOF%d height 0)", marker - 0xC0);
  if (d->width == 0) FAIL(MMR_CORRUPT, "JPEG width 0");
  if (d->ncomp != 1 && d->ncomp != 3)
    FAIL(MMR_UNSUPPORTED, "%d-component JPEG (this decoder takes 1 or 3)", d->ncomp);
  if (len < 6 + 3 * d->ncomp) FAIL(MMR_CORRUPT, "truncated JPEG frame header");
  d->hmax = d->vmax = 1;
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->c[i];
    c->id = s[6 + 3 * i];
    c->h = s[7 + 3 * i] >> 4;
    c->v = s[7 + 3 * i] & 15;
    c->tq = s[8 + 3 * i];
    if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
      FAIL(MMR_CORRUPT, "JPEG component %d: sampling %dx%d, table %d", i, c->h, c->v, c->tq);
    d->hmax = c->h > d->hmax ? c->h : d->hmax;
    d->vmax = c->v > d->vmax ? c->v : d->vmax;
  }
  if (d->ncomp == 3) {
    for (int i = 0; i < 3; i++) {
      int rh = d->hmax / d->c[i].h, rv = d->vmax / d->c[i].v;
      if (d->hmax % d->c[i].h || d->vmax % d->c[i].v || rh > 2 || rv > rh)
        FAIL(MMR_UNSUPPORTED,
             "JPEG sampling factors %dx%d, %dx%d, %dx%d (this decoder takes 4:4:4, "
             "4:2:2 and 4:2:0)",
             d->c[0].h, d->c[0].v, d->c[1].h, d->c[1].v, d->c[2].h, d->c[2].v);
    }
  }
  if ((size_t)d->height * d->width * d->ncomp > d->cap)
    FAIL(MMR_CORRUPT, "JPEG image of %dx%dx%d, the buffer holds %zu", d->height, d->width,
         d->ncomp, d->cap);
  d->mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
  d->mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->c[i];
    c->dw = (int)(((int64_t)d->width * c->h + d->hmax - 1) / d->hmax);
    c->dh = (int)(((int64_t)d->height * c->v + d->vmax - 1) / d->vmax);
    c->stride = d->mcux * c->h * 8;
    c->bh = d->mcuy * c->v;
    c->plane = calloc((size_t)c->stride * c->bh * 8, 1);
    if (!c->plane) FAIL(MMR_NOMEM, "out of memory");
  }
  d->sof = marker;
  return MMR_OK;
}

static int read_dht(jdec *d, const uint8_t *s, int len) {
  int p = 0;
  while (p < len) {
    if (len - p < 17) FAIL(MMR_CORRUPT, "truncated JPEG Huffman table");
    int tc = s[p] >> 4, th = s[p] & 15, total = 0;
    if (tc > 1 || th > 3) FAIL(MMR_CORRUPT, "JPEG Huffman table class %d slot %d", tc, th);
    htab *t = tc ? &d->ac[th] : &d->dc[th];
    t->bits[0] = 0;
    for (int l = 1; l <= 16; l++) total += t->bits[l] = s[p + l];
    p += 17;
    if (total > 256 || len - p < total) FAIL(MMR_CORRUPT, "truncated JPEG Huffman table");
    memcpy(t->vals, s + p, total);
    p += total;
    t->defined = 1;
  }
  return MMR_OK;
}

static int read_dqt(jdec *d, const uint8_t *s, int len) {
  int p = 0;
  while (p < len) {
    int pq = s[p] >> 4, tq = s[p] & 15, need = pq ? 128 : 64;
    if (pq > 1 || tq > 3) FAIL(MMR_CORRUPT, "JPEG quantization table %d precision %d", tq, pq);
    if (len - p - 1 < need) FAIL(MMR_CORRUPT, "truncated JPEG quantization table");
    for (int k = 0; k < 64; k++)
      d->q[tq][ZZ[k]] = pq ? (uint16_t)be16(s + p + 1 + 2 * k) : s[p + 1 + k];
    d->qdef[tq] = 1;
    p += 1 + need;
  }
  return MMR_OK;
}

/* past the RSTn marker that ends a restart interval */
static int restart(jdec *d, jbits *b) {
  const uint8_t *p = b->p;
  while (p + 1 < b->end && !(p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF)) p++;
  if (p + 1 >= b->end || p[1] < 0xD0 || p[1] > 0xD7)
    FAIL(MMR_CORRUPT, "JPEG restart marker missing at byte %zu", (size_t)(p - d->src));
  b->p = p + 2;
  b->acc = 0;
  b->nbits = 0;
  b->marker = 0;
  for (int i = 0; i < d->ncomp; i++) d->c[i].dc_pred = 0;
  return MMR_OK;
}

/* one scan from s (past its header) to the next marker; *next: the
 * offset of that marker */
static int read_scan(jdec *d, const uint8_t *s, int len, size_t body, size_t *next) {
  if (!d->sof) FAIL(MMR_CORRUPT, "JPEG scan before its frame header");
  int ns = s[0];
  comp_t *sc[4];
  if (ns < 1 || ns > d->ncomp || len < 4 + 2 * ns) FAIL(MMR_CORRUPT, "JPEG scan header");
  for (int i = 0; i < ns; i++) {
    int id = s[1 + 2 * i], tt = s[2 + 2 * i], k;
    for (k = 0; k < d->ncomp && d->c[k].id != id; k++) {
    }
    if (k == d->ncomp) FAIL(MMR_CORRUPT, "JPEG scan names component %d", id);
    sc[i] = &d->c[k];
    sc[i]->td = tt >> 4;
    sc[i]->ta = tt & 15;
    if (sc[i]->td > 3 || sc[i]->ta > 3) FAIL(MMR_CORRUPT, "JPEG scan table slot");
    if (!d->qdef[sc[i]->tq]) FAIL(MMR_CORRUPT, "JPEG quantization table %d missing", sc[i]->tq);
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
  if (ss != 0 || se != 63 || ah || al)
    FAIL(MMR_CORRUPT, "JPEG sequential scan with spectral selection %d..%d, approximation %d/%d",
         ss, se, ah, al);
  for (int i = 0; i < ns; i++) {
    htab *dc = &d->dc[sc[i]->td], *ac = &d->ac[sc[i]->ta];
    if (!dc->defined && sc[i]->td < 2)
      std_table(dc, sc[i]->td ? STD_DC_C_BITS : STD_DC_L_BITS, STD_DC_VALS, 12);
    if (!ac->defined && sc[i]->ta < 2)
      std_table(ac, sc[i]->ta ? STD_AC_C_BITS : STD_AC_L_BITS,
                sc[i]->ta ? STD_AC_C_VALS : STD_AC_L_VALS, 162);
    if (!dc->defined || !ac->defined || derive(dc, 1) || derive(ac, 0))
      FAIL(MMR_CORRUPT, "JPEG Huffman table %d/%d missing or invalid", sc[i]->td, sc[i]->ta);
    sc[i]->dc_pred = 0;
  }
  jbits b = {d->src + body, d->src + d->n, 0, 0, 0};
  int16_t blk[64];
  long mcus;
  int nbx = 0;
  if (ns == 1) {
    nbx = (sc[0]->dw + 7) / 8;
    mcus = (long)nbx * ((sc[0]->dh + 7) / 8);
  } else {
    mcus = (long)d->mcux * d->mcuy;
  }
  for (long m = 0; m < mcus; m++) {
    if (d->restart && m && m % d->restart == 0) {
      int rc = restart(d, &b);
      if (rc) return rc;
    }
    for (int i = 0; i < ns; i++) {
      comp_t *c = sc[i];
      int bw = ns == 1 ? 1 : c->h, bhh = ns == 1 ? 1 : c->v;
      for (int v = 0; v < bhh; v++)
        for (int h = 0; h < bw; h++) {
          int bx, by;
          if (ns == 1) {
            bx = (int)(m % nbx);
            by = (int)(m / nbx);
          } else {
            bx = (int)(m % d->mcux) * c->h + h;
            by = (int)(m / d->mcux) * c->v + v;
          }
          if (decode_block(&b, &d->dc[c->td], &d->ac[c->ta], &c->dc_pred, blk))
            FAIL(MMR_CORRUPT, "corrupt JPEG entropy data in MCU %ld", m);
          idct_islow(blk, d->q[c->tq], c->plane + (size_t)by * 8 * c->stride + bx * 8,
                     c->stride);
        }
    }
  }
  /* the next marker: where the reader stopped, else past the last bytes */
  const uint8_t *p = b.p;
  while (p + 1 < b.end && !(p[0] == 0xFF && p[1] != 0 && !(p[1] >= 0xD0 && p[1] <= 0xD7)))
    p++;
  *next = (size_t)(p - d->src);
  return MMR_OK;
}

/* walk the markers; stop after the frame header when info_only */
static int parse(jdec *d, int info_only) {
  const uint8_t *s = d->src;
  size_t n = d->n, p = 2;
  if (n < 4 || s[0] != 0xFF || s[1] != 0xD8) FAIL(MMR_CORRUPT, "not a JPEG image (no SOI)");
  for (;;) {
    while (p < n && s[p] != 0xFF) p++;
    while (p < n && s[p] == 0xFF) p++;
    if (p >= n) FAIL(MMR_CORRUPT, "JPEG image ends without EOI");
    int m = s[p++];
    if (m == 0xD9) break;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (n - p < 2) FAIL(MMR_CORRUPT, "truncated JPEG marker 0x%02X", m);
    int len = be16(s + p) - 2;
    if (len < 0 || (size_t)len > n - p - 2)
      FAIL(MMR_CORRUPT, "JPEG marker 0x%02X runs past the image", m);
    const uint8_t *seg = s + p + 2;
    int rc = MMR_OK;
    if (m == 0xC0 || m == 0xC1) {
      if (d->sof) FAIL(MMR_CORRUPT, "second JPEG frame header");
      rc = read_sof(d, seg, len, m);
      if (rc == MMR_OK && info_only) return MMR_OK;
    } else if (sof_name(m)) {
      FAIL(MMR_UNSUPPORTED, "%s (this decoder takes baseline and extended-Huffman "
           "sequential JPEG, SOF0 and SOF1)", sof_name(m));
    } else if (m == 0xCC) {
      FAIL(MMR_UNSUPPORTED, "arithmetic-coded JPEG (DAC marker)");
    } else if (m == 0xDC) {
      FAIL(MMR_UNSUPPORTED, "JPEG DNL marker");
    } else if (m == 0xC4) {
      rc = read_dht(d, seg, len);
    } else if (m == 0xDB) {
      rc = read_dqt(d, seg, len);
    } else if (m == 0xDD) {
      if (len < 2) FAIL(MMR_CORRUPT, "JPEG restart interval");
      d->restart = be16(seg);
    } else if (m == 0xE0) {
      if (len >= 5 && !memcmp(seg, "JFIF", 5)) d->jfif = 1;
    } else if (m == 0xEE) {
      if (len >= 12 && !memcmp(seg, "Adobe", 5)) {
        d->adobe = 1;
        d->adobe_transform = seg[11];
      }
    } else if (m == 0xDA) {
      if (info_only) FAIL(MMR_CORRUPT, "JPEG scan before its frame header");
      size_t next = 0;
      rc = read_scan(d, seg, len, p + 2 + len, &next);
      if (rc == MMR_OK) {
        p = next;
        continue;
      }
    }
    if (rc != MMR_OK) return rc;
    p += 2 + len;
  }
  if (!d->sof) FAIL(MMR_CORRUPT, "JPEG image without a frame header");
  return MMR_OK;
}

/* ---------------------------------------------------------------- output */
/* component c's samples of output row y at full resolution (libjpeg's
 * upsamplers: none, h2v1 or h2v2, fancy where d->fancy is set and the
 * component is wider than 2 samples, else each sample repeated) */
static const uint8_t *upsampled_row(const jdec *d, const comp_t *c, int y, uint8_t *out) {
  int rh = d->hmax / c->h, rv = d->vmax / c->v, dw = c->dw;
  const uint8_t *in0 = c->plane + (size_t)(rv == 2 ? y >> 1 : y) * c->stride;
  if (rh == 1) return in0;
  if (!d->fancy || dw <= 2) {
    for (int i = 0; i < dw; i++) out[2 * i] = out[2 * i + 1] = in0[i];
    return out;
  }
  if (rv == 1) {
    out[0] = in0[0];
    out[1] = (uint8_t)((in0[0] * 3 + in0[1] + 2) >> 2);
    for (int i = 1; i < dw - 1; i++) {
      int v = in0[i] * 3;
      out[2 * i] = (uint8_t)((v + in0[i - 1] + 1) >> 2);
      out[2 * i + 1] = (uint8_t)((v + in0[i + 1] + 2) >> 2);
    }
    out[2 * dw - 2] = (uint8_t)((in0[dw - 1] * 3 + in0[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = in0[dw - 1];
    return out;
  }
  int iy = y >> 1, ny = (y & 1) ? (iy + 1 < c->dh ? iy + 1 : c->dh - 1) : (iy > 0 ? iy - 1 : 0);
  const uint8_t *in1 = c->plane + (size_t)ny * c->stride;
  int last = in0[0] * 3 + in1[0], cur = last, next = in0[1] * 3 + in1[1];
  out[0] = (uint8_t)((cur * 4 + 8) >> 4);
  out[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
  for (int i = 1; i < dw - 1; i++) {
    last = cur;
    cur = next;
    next = in0[i + 1] * 3 + in1[i + 1];
    out[2 * i] = (uint8_t)((cur * 3 + last + 8) >> 4);
    out[2 * i + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
  }
  last = cur;
  cur = next;
  out[2 * dw - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
  out[2 * dw - 1] = (uint8_t)((cur * 4 + 7) >> 4);
  return out;
}

static inline uint8_t clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

static int write_rgb(jdec *d, uint8_t *dst) {
  int W = d->width, H = d->height;
  if (d->ncomp == 1) {
    for (int y = 0; y < H; y++) memcpy(dst + (size_t)y * W, d->c[0].plane + (size_t)y * d->c[0].stride, W);
    return MMR_OK;
  }
  int rgb = !d->jfif && (d->adobe ? d->adobe_transform == 0
                                  : d->c[0].id == 'R' && d->c[1].id == 'G' && d->c[2].id == 'B');
  int crr[256], cbb[256];
  int32_t crg[256], cbg[256];
  const int32_t half = 1 << 15;
  for (int i = 0; i < 256; i++) {
    int32_t x = i - 128;
    crr[i] = (int)((91881 * x + half) >> 16);  /* FIX(1.40200) */
    cbb[i] = (int)((116130 * x + half) >> 16); /* FIX(1.77200) */
    crg[i] = -46802 * x;                       /* -FIX(0.71414) */
    cbg[i] = -22554 * x + half;                /* -FIX(0.34414) */
  }
  uint8_t *buf = malloc((size_t)3 * (W + 16));
  if (!buf) FAIL(MMR_NOMEM, "out of memory");
  for (int y = 0; y < H; y++) {
    const uint8_t *r0 = upsampled_row(d, &d->c[0], y, buf);
    const uint8_t *r1 = upsampled_row(d, &d->c[1], y, buf + (W + 16));
    const uint8_t *r2 = upsampled_row(d, &d->c[2], y, buf + 2 * (W + 16));
    uint8_t *o = dst + (size_t)y * W * 3;
    if (rgb) {
      for (int x = 0; x < W; x++) {
        o[3 * x] = r0[x];
        o[3 * x + 1] = r1[x];
        o[3 * x + 2] = r2[x];
      }
      continue;
    }
    for (int x = 0; x < W; x++) {
      int yy = r0[x], cb = r1[x], cr = r2[x];
      o[3 * x] = clamp255(yy + crr[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((cbg[cb] + crg[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + cbb[cb]);
    }
  }
  free(buf);
  return MMR_OK;
}

static void release(jdec *d) {
  for (int i = 0; i < 3; i++) free(d->c[i].plane);
  free(d);
}

static jdec *make(const uint8_t *src, size_t n, size_t cap, char *err, size_t errlen) {
  jdec *d = calloc(1, sizeof(jdec));
  if (d) {
    d->src = src;
    d->n = n;
    d->cap = cap;
    d->err = err;
    d->errlen = errlen;
  }
  return d;
}

int mmr_jpeg_info(const uint8_t *src, size_t n, int *height, int *width, int *components,
                  char *err, size_t errlen) {
  jdec *d = make(src, n, SIZE_MAX, err, errlen);
  if (!d) return mmr_set_error(err, errlen, MMR_NOMEM, "out of memory");
  int rc = parse(d, 1);
  if (rc == MMR_OK && !d->sof) rc = mmr_set_error(err, errlen, MMR_CORRUPT, "no JPEG frame header");
  if (rc == MMR_OK) {
    *height = d->height;
    *width = d->width;
    *components = d->ncomp;
  }
  release(d);
  return rc;
}

int mmr_jpeg_decode(const uint8_t *src, size_t n, uint8_t *dst, size_t cap, int fancy,
                    char *err, size_t errlen) {
  jdec *d = make(src, n, cap, err, errlen);
  if (!d) return mmr_set_error(err, errlen, MMR_NOMEM, "out of memory");
  d->fancy = fancy;
  int rc = parse(d, 0);
  if (rc == MMR_OK) rc = write_rgb(d, dst);
  release(d);
  return rc;
}
