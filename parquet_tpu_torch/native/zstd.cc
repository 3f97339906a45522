// The ZSTD block codec of parquet_tpu_torch, over the system's libzstd.
//
// The reference compresses with the zstandard package's ZstdCompressor()
// (level 3, the frame's content size written, no checksum) and
// decompresses with its ZstdDecompressor; this is the same over libzstd's
// simple API. Built alone into libpqt_zstd.so by
// parquet_tpu_torch/kernels/host_build.py at the first ZSTD use, apart
// from libpqt_host.so, so that a host without libzstd loses ZSTD only.
// Bound with ctypes in parquet_tpu_torch/core/compress.py.
//
// A host with libzstd's runtime library but not its development header
// (zstd.h) still builds it: the few functions of libzstd's stable API that
// this file calls are declared below, as zstd.h declares them, and
// host_build.py links the runtime library by its soname. PQT_ZSTD_DECLARE
// forces that branch where the header is present.
//
// The codec runs on several pqt-host prepare threads at once: each thread
// keeps its own compression and decompression context (thread_local),
// never one shared across threads.

#if !defined(PQT_ZSTD_DECLARE) && __has_include(<zstd.h>)
#include <zstd.h>
#else
#include <cstddef>
extern "C" {
// libzstd's stable API (zstd.h, every 1.x release), opaque contexts
typedef struct ZSTD_CCtx_s ZSTD_CCtx;
typedef struct ZSTD_DCtx_s ZSTD_DCtx;
unsigned ZSTD_versionNumber(void);
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);
const char* ZSTD_getErrorName(size_t code);
ZSTD_CCtx* ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx* cctx);
ZSTD_DCtx* ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx* dctx);
size_t ZSTD_compressCCtx(ZSTD_CCtx* cctx, void* dst, size_t dstCapacity, const void* src,
                         size_t srcSize, int compressionLevel);
size_t ZSTD_decompressDCtx(ZSTD_DCtx* dctx, void* dst, size_t dstCapacity, const void* src,
                           size_t srcSize);
}
#endif

#include <cstdint>
#include <cstring>

namespace {

struct Contexts {
  ZSTD_CCtx* c = nullptr;
  ZSTD_DCtx* d = nullptr;
  ~Contexts() {
    ZSTD_freeCCtx(c);
    ZSTD_freeDCtx(d);
  }
};

thread_local Contexts ctx;
thread_local char last_error[256];

long long fail(size_t code) {
  std::strncpy(last_error, ZSTD_getErrorName(code), sizeof(last_error) - 1);
  last_error[sizeof(last_error) - 1] = 0;
  return -1;
}

}  // namespace

extern "C" {

// The most bytes ptq_zstd_compress can write for n input bytes.
long long ptq_zstd_bound(long long n) { return (long long)ZSTD_compressBound((size_t)n); }

// Compress src[0:n] into dst[0:cap] at `level`; the compressed size, or -1
// (ptq_zstd_error names the failure).
long long ptq_zstd_compress(const uint8_t* src, long long n, uint8_t* dst, long long cap,
                            int level) {
  if (n < 0 || cap < 0) return -1;
  if (ctx.c == nullptr && (ctx.c = ZSTD_createCCtx()) == nullptr) {
    std::strcpy(last_error, "cannot allocate a compression context");
    return -1;
  }
  size_t r = ZSTD_compressCCtx(ctx.c, dst, (size_t)cap, src, (size_t)n, level);
  return ZSTD_isError(r) ? fail(r) : (long long)r;
}

// Decompress the frames of src[0:n] into dst[0:cap]; the decompressed
// size, or -1 (a corrupt stream, or one that inflates past cap).
long long ptq_zstd_decompress(const uint8_t* src, long long n, uint8_t* dst, long long cap) {
  if (n < 0 || cap < 0) return -1;
  if (ctx.d == nullptr && (ctx.d = ZSTD_createDCtx()) == nullptr) {
    std::strcpy(last_error, "cannot allocate a decompression context");
    return -1;
  }
  size_t r = ZSTD_decompressDCtx(ctx.d, dst, (size_t)cap, src, (size_t)n);
  return ZSTD_isError(r) ? fail(r) : (long long)r;
}

// The calling thread's last failure, as libzstd names it.
const char* ptq_zstd_error(void) { return last_error; }

// libzstd's version number (10000 * major + 100 * minor + patch).
unsigned ptq_zstd_version(void) { return ZSTD_versionNumber(); }

}  // extern "C"
