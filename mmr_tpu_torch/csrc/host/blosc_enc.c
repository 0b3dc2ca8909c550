/* c-blosc 1.x chunks (header version 2) over zstd, as tensorstore's
 * c-blosc writes the reference's codec (zarr v3 "blosc": cname zstd,
 * clevel 3, bitshuffle) and its byte-shuffled and unshuffled variants.
 *
 * The header: version 2, versionlz 1, flags no-split | zstd with the
 * array's shuffle (0x94 bitshuffle, 0x91 byte shuffle, 0x90 none: c-blosc
 * sets the shuffle flag at any typesize), the typesize, nbytes, c-blosc's
 * block size for zstd at clevel 3 (128 KiB where the chunk holds that
 * much, else the whole chunk, a multiple of the typesize) and cbytes; one
 * int32 start offset a block; each block shuffled (byte shuffle as
 * c-blosc's shuffle.c, the bytes past the last whole element kept in
 * place; bitshuffle.h: a block whose element count is not a multiple of 8
 * is kept as it is) and written as one stream, its int32 size and a zstd
 * frame, or its raw bytes where the frame is not smaller.
 * A chunk of fewer than 128 bytes, or one whose streams do not fit in
 * nbytes + 16, is stored memcpyed (flag 0x02) as c-blosc stores it. */
#include <stdlib.h>
#include <string.h>

#include "bitshuffle.h"
#include "mmr_host.h"

#define BLOSC_MEMCPYED 0x02
#define BLOSC_FLAGS (0x10 | 4 << 5) /* no split, zstd */
static const uint8_t SHUFFLE_FLAGS[3] = {0x00, 0x01, 0x04}; /* none, byte, bit */
#define MIN_BUFFERSIZE 128
#define MAX_OVERHEAD 16
/* the shortest match: on bitshuffled image planes matches under 7 bytes
 * cost more in sequences than they save in literals, and decode slower;
 * a block left unshuffled or byte-shuffled holds whole elements or byte
 * planes, whose repeats are shorter */
#define MATCH_BITSHUFFLED 7
#define MATCH_UNSHUFFLED 4

static void put32(uint8_t *p, uint32_t v) { memcpy(p, &v, 4); }

/* c-blosc's byte shuffle: byte j of element i to j * n + i */
static void byte_shuffle(size_t ts, size_t bsize, const uint8_t *src, uint8_t *dst) {
  size_t n = bsize / ts;
  for (size_t i = 0; i < n; i++)
    for (size_t j = 0; j < ts; j++) dst[j * n + i] = src[i * ts + j];
  memcpy(dst + n * ts, src + n * ts, bsize - n * ts);
}

/* c-blosc 1.x's compute_blocksize for zstd at clevel 3, no forced size */
static size_t blocksize_for(size_t nbytes, size_t ts) {
  if (nbytes < ts) return 1;
  size_t bs = nbytes >= 32 * 1024 ? 32 * 1024 * 2 * 2 : nbytes; /* L1, x2 for zstd, x2 clevel 3 */
  if (bs > nbytes) bs = nbytes;
  if (bs > ts) bs = bs / ts * ts;
  return bs;
}

size_t mmr_blosc_compress_bound(size_t n) { return n + MAX_OVERHEAD; }

int mmr_blosc_compress(const uint8_t *src, size_t n, size_t ts, int shuffle, uint8_t *dst,
                       size_t cap, size_t *written, char *err, size_t errlen) {
  *written = 0;
  if (shuffle < 0 || shuffle > 2)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED,
                         "blosc shuffle %d (0 none, 1 byte shuffle, 2 bitshuffle)", shuffle);
  if (ts < 1 || ts > 255)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED,
                         "blosc typesize %zu (c-blosc 1.x takes 1 to 255)", ts);
  if (n > 0x7FFFFFFFu - MAX_OVERHEAD)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED,
                         "blosc chunk of %zu bytes (c-blosc 1.x takes less than 2 GiB)", n);
  if (cap < n + MAX_OVERHEAD)
    return mmr_set_error(err, errlen, MMR_CORRUPT,
                         "blosc output buffer of %zu bytes, %zu bytes of input need %zu", cap,
                         n, n + MAX_OVERHEAD);
  size_t bs = blocksize_for(n, ts), nblocks = n ? (n + bs - 1) / bs : 0;
  uint8_t flags = BLOSC_FLAGS | SHUFFLE_FLAGS[shuffle];
  size_t limit = n + MAX_OVERHEAD, p = MAX_OVERHEAD + 4 * nblocks;
  int rc = MMR_OK, memcpyed = n < MIN_BUFFERSIZE || p > limit;
  if (!memcpyed) {
    mmr_zstd_enc *z = mmr_zstd_enc_new();
    uint8_t *shuf = malloc(bs), *frame = malloc(mmr_zstd_compress_bound(bs));
    if (!z || !shuf || !frame) {
      rc = mmr_set_error(err, errlen, MMR_NOMEM, "out of memory");
    } else {
      for (size_t b = 0; b < nblocks && !memcpyed; b++) {
        size_t bsize = b + 1 < nblocks || n % bs == 0 ? bs : n % bs, got;
        const uint8_t *block = src + b * bs;
        size_t mm = MATCH_UNSHUFFLED;
        if (shuffle == 2) {
          bitshuffle_block(ts, bsize, block, shuf);
          block = shuf;
          if ((bsize / ts) % 8 == 0) mm = MATCH_BITSHUFFLED;
        } else if (shuffle == 1) {
          byte_shuffle(ts, bsize, block, shuf);
          block = shuf;
        }
        rc = mmr_zstd_compress_with(z, block, bsize, mm, frame, mmr_zstd_compress_bound(bs), &got,
                                    err, errlen);
        if (rc != MMR_OK) break;
        const uint8_t *stream = got < bsize ? frame : block;
        size_t size = got < bsize ? got : bsize;
        if (p + 4 + size > limit) {
          memcpyed = 1;
          break;
        }
        put32(dst + MAX_OVERHEAD + 4 * b, (uint32_t)p);
        put32(dst + p, (uint32_t)size);
        memcpy(dst + p + 4, stream, size);
        p += 4 + size;
      }
    }
    free(frame);
    free(shuf);
    mmr_zstd_enc_free(z);
    if (rc != MMR_OK) return rc;
  }
  if (memcpyed) {
    flags |= BLOSC_MEMCPYED;
    memcpy(dst + MAX_OVERHEAD, src, n);
    p = MAX_OVERHEAD + n;
  }
  dst[0] = 2;
  dst[1] = 1;
  dst[2] = flags;
  dst[3] = (uint8_t)ts;
  put32(dst + 4, (uint32_t)n);
  put32(dst + 8, (uint32_t)bs);
  put32(dst + 12, (uint32_t)p);
  *written = p;
  return MMR_OK;
}
