/* Host-side codecs of the port's data path, with a plain C interface
 * that ctypes loads (mmr_tpu_torch/data/hostlib.py builds them with cc).
 *
 *   zstd_dec.c   zstd frames (RFC 8878), no dictionaries
 *   zstd_enc.c   one zstd frame: greedy matching, Huffman literals, FSE
 *                sequences, the reference's one setting (blosc clevel 3)
 *   lz_dec.c     blosclz, lz4 and snappy block streams
 *   inflate.c    zlib streams (RFC 1950 / 1951)
 *   blosc_dec.c  c-blosc 1.x frames (header version 2) over any of them
 *   blosc_enc.c  c-blosc 1.x frames over zstd as tensorstore writes the
 *                reference's codec (clevel 3; bitshuffle, byte shuffle
 *                or none)
 *   bitshuffle.h c-blosc's bitshuffle both ways, on 64-bit words
 *   jpeg_dec.c   Huffman-coded 8-bit JPEG, baseline, extended and
 *                progressive, decoded as libjpeg-turbo does by default
 *                (ISLOW IDCT, fancy upsampling, its fixed-point YCbCr ->
 *                RGB), or with the chroma as OpenCV's FFmpeg backend
 *                gives it (swscale)
 *
 * Every entry returns MMR_OK, MMR_CORRUPT (the input is damaged: Python
 * raises ValueError) or MMR_UNSUPPORTED (a valid input this library does
 * not decode or encode: NotImplementedError), MMR_NOMEM (MemoryError),
 * and on failure writes a message into
 * err[0 .. errlen). No entry reads or writes outside the buffers it is
 * given; none holds state between calls, so calls on many threads at once
 * are safe. */
#ifndef MMR_HOST_H
#define MMR_HOST_H

#include <stddef.h>
#include <stdint.h>

#define MMR_OK 0
#define MMR_CORRUPT 1
#define MMR_UNSUPPORTED 2
#define MMR_NOMEM 3

/* All zstd frames of src[0 .. n) into dst[0 .. cap); *written = bytes
 * produced. Skippable frames are skipped, checksums are not verified. */
int mmr_zstd_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                        size_t *written, char *err, size_t errlen);

/* One block stream of blosc's other compressors into dst[0 .. cap);
 * *written = the bytes produced. Not entries of the Python binding:
 * blosc_dec.c calls them. */
int mmr_blosclz_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                           size_t *written, char *err, size_t errlen);
int mmr_lz4_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                       size_t *written, char *err, size_t errlen);
int mmr_snappy_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                          size_t *written, char *err, size_t errlen);
int mmr_zlib_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                        size_t *written, char *err, size_t errlen);

/* One blosc 1.x chunk into dst[0 .. cap); *written = its nbytes. */
int mmr_blosc_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                         size_t *written, char *err, size_t errlen);

/* src[0 .. n) as one zstd frame into dst[0 .. cap), cap at least
 * mmr_zstd_compress_bound(n); *written = the frame's size. */
size_t mmr_zstd_compress_bound(size_t n);
int mmr_zstd_compress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap, size_t *written,
                      char *err, size_t errlen);

/* src[0 .. n), elements of typesize bytes, as one blosc 1.x chunk (zstd;
 * shuffle 0 none, 1 byte shuffle, 2 bitshuffle) into dst[0 .. cap), cap at
 * least mmr_blosc_compress_bound(n). */
size_t mmr_blosc_compress_bound(size_t n);
int mmr_blosc_compress(const uint8_t *src, size_t n, size_t typesize, int shuffle, uint8_t *dst,
                       size_t cap, size_t *written, char *err, size_t errlen);

/* The zstd encoder's working memory (about 1 MB), for a caller that
 * writes many frames on one thread (blosc_enc.c; not an entry of the
 * Python binding); min_match, 4 to 8, the shortest match it looks for
 * (mmr_zstd_compress: 4). */
typedef struct mmr_zstd_enc mmr_zstd_enc;
mmr_zstd_enc *mmr_zstd_enc_new(void);
void mmr_zstd_enc_free(mmr_zstd_enc *z);
int mmr_zstd_compress_with(mmr_zstd_enc *z, const uint8_t *src, size_t n, size_t min_match,
                           uint8_t *dst, size_t cap, size_t *written, char *err,
                           size_t errlen);

/* The frame size and component count (1 or 3) of a JPEG image. */
int mmr_jpeg_info(const uint8_t *src, size_t n, int *height, int *width,
                  int *components, char *err, size_t errlen);

/* A JPEG image into dst (height x width x components uint8, row-major;
 * three components as RGB); cap = dst's size in bytes. fancy = 1:
 * libjpeg's chroma upsampling; 0: OpenCV's (swscale's) chroma. */
int mmr_jpeg_decode(const uint8_t *src, size_t n, uint8_t *dst, size_t cap, int fancy,
                    char *err, size_t errlen);

int mmr_set_error(char *err, size_t errlen, int code, const char *fmt, ...);

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "the host decoders assume a little-endian host"
#endif

#endif
