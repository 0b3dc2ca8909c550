/* Host-side decoders of the port's data path, with a plain C interface
 * that ctypes loads (mmr_tpu_torch/data/hostlib.py builds them with cc).
 *
 *   zstd_dec.c   zstd frames (RFC 8878), no dictionaries
 *   blosc_dec.c  c-blosc 1.x frames (header version 2) over zstd streams
 *   jpeg_dec.c   baseline / extended-Huffman 8-bit JPEG, decoded as
 *                libjpeg-turbo does by default (ISLOW IDCT, fancy
 *                upsampling, its fixed-point YCbCr -> RGB), or with the
 *                chroma samples repeated as OpenCV's FFmpeg backend does
 *
 * Every entry returns MMR_OK, MMR_CORRUPT (the input is damaged: Python
 * raises ValueError) or MMR_UNSUPPORTED (a valid input this library does
 * not decode: NotImplementedError), and on failure writes a message into
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

/* One blosc 1.x chunk into dst[0 .. cap); *written = its nbytes. */
int mmr_blosc_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap,
                         size_t *written, char *err, size_t errlen);

/* The frame size and component count (1 or 3) of a JPEG image. */
int mmr_jpeg_info(const uint8_t *src, size_t n, int *height, int *width,
                  int *components, char *err, size_t errlen);

/* A JPEG image into dst (height x width x components uint8, row-major;
 * three components as RGB); cap = dst's size in bytes. fancy = 1:
 * libjpeg's triangular chroma upsampling; 0: each chroma sample repeated
 * over the pixels it covers. */
int mmr_jpeg_decode(const uint8_t *src, size_t n, uint8_t *dst, size_t cap, int fancy,
                    char *err, size_t errlen);

int mmr_set_error(char *err, size_t errlen, int code, const char *fmt, ...);

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "the host decoders assume a little-endian host"
#endif

#endif
