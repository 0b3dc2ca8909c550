/* c-blosc 1.x chunks (header version 2) over each compressor tensorstore
 * writes: zstd, the reference converter's (zarr v3 "blosc", cname zstd),
 * and blosclz, lz4 (lz4hc writes the same streams), snappy and zlib
 * (lz_dec.c, inflate.c).
 *
 * The 16-byte header (version, versionlz, flags, typesize, nbytes,
 * blocksize, cbytes), then either the raw bytes (flag 0x02, memcpyed) or
 * one int32 start offset a block followed by the blocks. A block is one
 * stream, or typesize streams (split: the flag 0x10 clear and the block
 * not the leftover one); each stream is its int32 compressed size and its
 * bytes, stored raw where that size equals the stream's raw size. The
 * block is then unshuffled: byte shuffle (0x01, typesize > 1) or
 * bitshuffle (0x04, block >= typesize). c-blosc's bitshuffle transposes
 * a block whose element count is a multiple of 8 (bytes past its last
 * whole element copied) and stores any other block as it is: a chunk of
 * 105 float32 or 221 uint8 elements written by tensorstore holds its
 * bytes unshuffled. The delta filter (0x08) is refused by name. */
#include <stdlib.h>
#include <string.h>

#include "bitshuffle.h"
#include "mmr_host.h"

#define BLOSC_DOSHUFFLE 0x01
#define BLOSC_MEMCPYED 0x02
#define BLOSC_DOBITSHUFFLE 0x04
#define BLOSC_DODELTA 0x08
#define BLOSC_NOSPLIT 0x10

typedef int (*stream_decoder)(const uint8_t *, size_t, uint8_t *, size_t, size_t *, char *,
                              size_t);
/* by the compressor code in the flags' top 3 bits */
static const stream_decoder DECODERS[8] = {mmr_blosclz_decompress, mmr_lz4_decompress,
                                           mmr_snappy_decompress,  mmr_zlib_decompress,
                                           mmr_zstd_decompress};

static inline uint32_t le32(const uint8_t *p) {
  return p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}

static void unshuffle(size_t ts, size_t bsize, const uint8_t *src, uint8_t *dst) {
  size_t n = bsize / ts;
  for (size_t j = 0; j < ts; j++)
    for (size_t i = 0; i < n; i++) dst[i * ts + j] = src[j * n + i];
  memcpy(dst + n * ts, src + n * ts, bsize - n * ts);
}

int mmr_blosc_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                         size_t *written, char *err, size_t errlen) {
  *written = 0;
  if (n < 16)
    return mmr_set_error(err, errlen, MMR_CORRUPT,
                         "blosc chunk of %zu bytes, shorter than its 16-byte header", n);
  int version = src[0], flags = src[2];
  size_t ts = src[3], nbytes = le32(src + 4), blocksize = le32(src + 8),
         cbytes = le32(src + 12);
  if (version != 2)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED,
                         "blosc header version %d (this reader takes version 2, "
                         "written by c-blosc 1.x)",
                         version);
  if (cbytes > n || cbytes < 16)
    return mmr_set_error(err, errlen, MMR_CORRUPT,
                         "blosc chunk says %zu compressed bytes, %zu are there", cbytes, n);
  if (nbytes > cap)
    return mmr_set_error(err, errlen, MMR_CORRUPT,
                         "blosc chunk of %zu bytes, the buffer holds %zu", nbytes, cap);
  if (flags & BLOSC_MEMCPYED) {
    if (16 + nbytes > cbytes)
      return mmr_set_error(err, errlen, MMR_CORRUPT, "truncated memcpyed blosc chunk");
    memcpy(dst, src + 16, nbytes);
    *written = nbytes;
    return MMR_OK;
  }
  stream_decoder decode = DECODERS[flags >> 5];
  if (!decode)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED,
                         "blosc compressor code %d (this reader takes blosclz, lz4, lz4hc, "
                         "snappy, zlib and zstd)",
                         flags >> 5);
  if (flags & BLOSC_DODELTA)
    return mmr_set_error(err, errlen, MMR_UNSUPPORTED, "blosc delta filter");
  if (nbytes == 0) return MMR_OK;
  if (ts == 0 || blocksize == 0)
    return mmr_set_error(err, errlen, MMR_CORRUPT, "blosc typesize %zu, blocksize %zu",
                         ts, blocksize);
  size_t nblocks = nbytes / blocksize, leftover = nbytes % blocksize;
  nblocks += leftover != 0;
  if (16 + 4 * nblocks > cbytes)
    return mmr_set_error(err, errlen, MMR_CORRUPT, "truncated blosc block starts");
  int shuffle = (flags & BLOSC_DOSHUFFLE) && ts > 1;
  uint8_t *tmp = NULL;
  if (shuffle || (flags & BLOSC_DOBITSHUFFLE)) {
    tmp = malloc(blocksize);
    if (!tmp) return mmr_set_error(err, errlen, MMR_NOMEM, "out of memory");
  }
  int rc = MMR_OK;
  for (size_t b = 0; b < nblocks && rc == MMR_OK; b++) {
    int last = leftover && b == nblocks - 1;
    size_t bsize = last ? leftover : blocksize;
    int bitshuffle = !shuffle && (flags & BLOSC_DOBITSHUFFLE) && bsize >= ts;
    size_t nsplit = (!(flags & BLOSC_NOSPLIT) && !last) ? ts : 1;
    size_t neblock = bsize / nsplit, p = le32(src + 16 + 4 * b);
    uint8_t *out = (shuffle || bitshuffle) ? tmp : dst + b * blocksize;
    if (bsize % nsplit) {
      rc = mmr_set_error(err, errlen, MMR_CORRUPT, "blosc block of %zu bytes in %zu streams",
                         bsize, nsplit);
      break;
    }
    for (size_t j = 0; j < nsplit; j++) {
      size_t cs;
      if (p > cbytes || cbytes - p < 4 || (cs = le32(src + p)) > cbytes - p - 4) {
        rc = mmr_set_error(err, errlen, MMR_CORRUPT,
                           "blosc block %zu stream %zu runs past the chunk's %zu bytes", b,
                           j, cbytes);
        break;
      }
      p += 4;
      if (cs == neblock) {
        memcpy(out + j * neblock, src + p, neblock);
      } else {
        size_t got;
        rc = decode(src + p, cs, out + j * neblock, neblock, &got, err, errlen);
        if (rc == MMR_OK && got != neblock)
          rc = mmr_set_error(err, errlen, MMR_CORRUPT,
                             "blosc block %zu stream %zu gave %zu bytes, not %zu", b, j, got,
                             neblock);
        if (rc != MMR_OK) break;
      }
      p += cs;
    }
    if (rc != MMR_OK) break;
    if (shuffle)
      unshuffle(ts, bsize, tmp, dst + b * blocksize);
    else if (bitshuffle)
      bitunshuffle_block(ts, bsize, tmp, dst + b * blocksize);
  }
  free(tmp);
  if (rc == MMR_OK) *written = nbytes;
  return rc;
}
