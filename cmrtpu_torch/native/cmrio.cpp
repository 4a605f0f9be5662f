// cmrio — native host-IO core for cmrtpu_torch (a copy of cmrtpu's).
//
// The reference delegates medical-image IO to SimpleITK's C++ core
// (ref: src/data/Dataset.py:163-250, src/models/predict_model.py:184-186).
// This is the TPU-rebuild's native equivalent: the byte-level hot path of
// NRRD/NIfTI decoding (gzip inflate, gzip deflate, and whole-file
// read+inflate) implemented in C++ with no Python in the loop, exposed
// through a C ABI consumed via ctypes. Header parsing and geometry handling
// stay in Python (cmrtpu_torch/io/nrrd.py, nifti.py) — they are cold.
//
// All functions release the GIL implicitly (ctypes), so the generator's
// thread pool decodes files in true parallelism.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Inflate a zlib- or gzip-wrapped stream into dst (capacity dst_cap).
// Returns the number of bytes written, or -1 on error, or -2 if dst is too
// small (caller should grow and retry).
int64_t cmr_inflate(const uint8_t* src, int64_t src_len,
                    uint8_t* dst, int64_t dst_cap) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // 32 + MAX_WBITS: auto-detect zlib vs gzip headers.
  if (inflateInit2(&zs, 32 + MAX_WBITS) != Z_OK) return -1;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_cap);
  int64_t total = 0;
  for (;;) {
    int rc = inflate(&zs, Z_NO_FLUSH);
    if (rc == Z_STREAM_END) {
      total = static_cast<int64_t>(zs.next_out - dst);
      // NRRD files may concatenate multiple gzip members; continue until
      // input is exhausted. (inflateReset2 clears total_out, so progress is
      // tracked through next_out instead.)
      if (zs.avail_in > 0) {
        if (zs.avail_out == 0) {
          // a member ended exactly at dst capacity with input remaining:
          // returning total here would silently drop the remaining members
          inflateEnd(&zs);
          return -2;  // grow dst and retry
        }
        if (inflateReset2(&zs, 32 + MAX_WBITS) != Z_OK) break;
        continue;
      }
      break;
    }
    if (rc == Z_BUF_ERROR || zs.avail_out == 0) {
      // Z_BUF_ERROR with output space remaining means no progress was
      // possible on the INPUT side: a truncated/corrupt stream, not a
      // too-small buffer — growing and retrying would never converge.
      int64_t verdict = (rc == Z_BUF_ERROR && zs.avail_out > 0) ? -1 : -2;
      inflateEnd(&zs);
      return verdict;
    }
    if (rc != Z_OK) {
      inflateEnd(&zs);
      return -1;
    }
  }
  inflateEnd(&zs);
  return total;
}

// Gzip-compress src into dst. Returns bytes written, -1 on error, -2 if dst
// too small. level: 1 (fast) .. 9.
int64_t cmr_deflate_gzip(const uint8_t* src, int64_t src_len,
                         uint8_t* dst, int64_t dst_cap, int level) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, 16 + MAX_WBITS, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_cap);
  int rc = deflate(&zs, Z_FINISH);
  int64_t total = static_cast<int64_t>(zs.total_out);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return (rc == Z_OK || rc == Z_BUF_ERROR) ? -2 : -1;
  return total;
}

// Read an entire file into dst (capacity dst_cap). Returns bytes read,
// -1 on IO error, -2 if dst too small (actual size written to *file_size).
int64_t cmr_read_file(const char* path, uint8_t* dst, int64_t dst_cap,
                      int64_t* file_size) {
  std::FILE* fh = std::fopen(path, "rb");
  if (!fh) return -1;
  std::fseek(fh, 0, SEEK_END);
  int64_t size = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  if (file_size) *file_size = size;
  if (size > dst_cap) {
    std::fclose(fh);
    return -2;
  }
  int64_t got = static_cast<int64_t>(std::fread(dst, 1, size, fh));
  std::fclose(fh);
  return got == size ? got : -1;
}

// Parallel batch inflate: n independent (src -> dst) streams decoded on a
// native thread pool (the generator-side analogue of the reference's
// ThreadPoolExecutor fan-out, ref: src/data/Generators.py:89-94, but with
// zero GIL involvement). Each out_len[i] receives the inflated size or a
// negative error code.
void cmr_inflate_batch(const uint8_t** srcs, const int64_t* src_lens,
                       uint8_t** dsts, const int64_t* dst_caps,
                       int64_t* out_lens, int32_t n, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      out_lens[i] = cmr_inflate(srcs[i], src_lens[i], dsts[i], dst_caps[i]);
    }
  };
  std::vector<std::thread> pool;
  int32_t k = n_threads < n ? n_threads : n;
  pool.reserve(k);
  for (int32_t t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

int32_t cmr_version() { return 1; }

}  // extern "C"
