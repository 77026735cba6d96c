// GIL-free batched .npy mel loader: parse header, crop, scale, assemble.
//
// A copy of the JAX package's text_to_sound_synthesis_tpu/native/npy_batch.cc
// for the port's input pipeline. It replaces the reference's torch DataLoader
// worker *processes* (Diffsound/sound_synthesis/data/build.py:404-473 spawns
// num_workers forked workers purely to hide .npy read+crop latency behind the
// GIL): one C++ call loads a whole batch with an internal std::thread pool —
// no GIL, no pickling, and only the cropped window of each file is read (seek
// per row), not the whole array. It runs on the host; it is no device kernel.
//
// Contract (must match data/transforms.py exactly):
//   * .npy v1/v2/v3, C-order, dtype <f4 or <f8, 2-D (H, W)
//   * crop  spec[top:top+mel_num, left:left+crop_len]   (offsets from Python,
//     which owns the RNG so determinism matches the pure-Python path)
//   * scale 2*x - 1 when scale_to_model_range != 0 (to_model_range)
//
// Built at first use by native/npy_loader.py with plain g++ (no pybind11 —
// the ABI is flat C, ctypes is enough).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long long H = 0, W = 0;
  int itemsize = 0;  // 4 or 8
  long long data_off = 0;
};

// Returns 0 on success; writes a message into err (errlen cap) otherwise.
int parse_header(FILE* f, const char* path, NpyInfo* info, char* err,
                 int errlen) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    snprintf(err, errlen, "%s: not a .npy file", path);
    return 1;
  }
  const int major = magic[6];
  unsigned long hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) { snprintf(err, errlen, "%s: truncated header", path); return 1; }
    hlen = b[0] | (b[1] << 8);
  } else if (major == 2 || major == 3) {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) { snprintf(err, errlen, "%s: truncated header", path); return 1; }
    hlen = (unsigned long)b[0] | ((unsigned long)b[1] << 8) |
           ((unsigned long)b[2] << 16) | ((unsigned long)b[3] << 24);
  } else {
    snprintf(err, errlen, "%s: unsupported .npy version %d", path, major);
    return 1;
  }
  // A real .npy header dict is <1 KiB; a corrupt/truncated length field can
  // decode to gigabytes — failing here keeps the IOError contract instead of
  // a bad_alloc escaping through the worker thread (std::terminate).
  if (hlen == 0 || hlen > (1u << 20)) {
    snprintf(err, errlen, "%s: implausible header length %lu", path, hlen);
    return 1;
  }
  std::string hdr(hlen, '\0');
  if (fread(&hdr[0], 1, hlen, f) != hlen) {
    snprintf(err, errlen, "%s: truncated header dict", path);
    return 1;
  }
  info->data_off = 8 + (major == 1 ? 2 : 4) + (long long)hlen;

  if (hdr.find("'<f4'") != std::string::npos || hdr.find("'=f4'") != std::string::npos) {
    info->itemsize = 4;
  } else if (hdr.find("'<f8'") != std::string::npos || hdr.find("'=f8'") != std::string::npos) {
    info->itemsize = 8;
  } else {
    snprintf(err, errlen, "%s: dtype not <f4/<f8", path);
    return 1;
  }
  size_t fo = hdr.find("'fortran_order':");
  if (fo == std::string::npos || hdr.find("False", fo) == std::string::npos) {
    snprintf(err, errlen, "%s: fortran_order not False", path);
    return 1;
  }
  size_t sh = hdr.find("'shape':");
  if (sh == std::string::npos) { snprintf(err, errlen, "%s: no shape", path); return 1; }
  size_t lp = hdr.find('(', sh);
  size_t rp = hdr.find(')', sh);
  if (lp == std::string::npos || rp == std::string::npos) {
    snprintf(err, errlen, "%s: bad shape tuple", path);
    return 1;
  }
  long long dims[3] = {0, 0, 0};
  int ndim = 0;
  const char* p = hdr.c_str() + lp + 1;
  const char* end = hdr.c_str() + rp;
  while (p < end && ndim < 3) {
    while (p < end && (*p == ' ' || *p == ',')) ++p;
    if (p >= end || *p < '0' || *p > '9') break;
    long long v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    dims[ndim++] = v;
  }
  if (ndim != 2) {
    snprintf(err, errlen, "%s: expected 2-D, got %d-D", path, ndim);
    return 1;
  }
  info->H = dims[0];
  info->W = dims[1];
  return 0;
}

// Load one cropped window into out (mel_num * crop_len floats).
int load_one(const char* path, int mel_num, int crop_len, long long top,
             long long left, float* out, int scale, char* err, int errlen) {
  FILE* f = fopen(path, "rb");
  if (!f) { snprintf(err, errlen, "%s: open failed", path); return 1; }
  NpyInfo info;
  if (parse_header(f, path, &info, err, errlen)) { fclose(f); return 1; }
  if (top < 0) top = (info.H - mel_num) / 2;    // center crop
  if (left < 0) left = (info.W - crop_len) / 2;
  if (top + mel_num > info.H || left + crop_len > info.W || top < 0 || left < 0) {
    snprintf(err, errlen, "%s: crop (%d,%d)@(%lld,%lld) outside (%lld,%lld)",
             path, mel_num, crop_len, top, left, info.H, info.W);
    fclose(f);
    return 1;
  }
  std::vector<unsigned char> row(crop_len * info.itemsize);
  for (int r = 0; r < mel_num; ++r) {
    const long long off =
        info.data_off + ((top + r) * info.W + left) * info.itemsize;
#if defined(_WIN32)
    fseek(f, (long)off, SEEK_SET);
#else
    fseeko(f, (off_t)off, SEEK_SET);
#endif
    if (fread(row.data(), info.itemsize, crop_len, f) != (size_t)crop_len) {
      snprintf(err, errlen, "%s: short read at row %lld", path, top + r);
      fclose(f);
      return 1;
    }
    float* dst = out + (long long)r * crop_len;
    if (info.itemsize == 4) {
      memcpy(dst, row.data(), crop_len * 4);
      if (scale) {
        for (int c = 0; c < crop_len; ++c) dst[c] = 2.0f * dst[c] - 1.0f;
      }
    } else {
      // match numpy: f8 scales in double, THEN casts (datasets.py builds
      // to_model_range(spec).astype(float32) with spec still float64)
      const double* src = reinterpret_cast<const double*>(row.data());
      if (scale) {
        for (int c = 0; c < crop_len; ++c) dst[c] = (float)(2.0 * src[c] - 1.0);
      } else {
        for (int c = 0; c < crop_len; ++c) dst[c] = (float)src[c];
      }
    }
  }
  fclose(f);
  return 0;
}

}  // namespace

extern "C" {

// Batched entry. tops/lefts: per-item crop offsets (-1 => centered).
// out: n * mel_num * crop_len float32, C-order. Returns 0 on success; on
// failure the first error message lands in errbuf.
int t2s_load_mel_batch(const char** paths, int n, int mel_num, int crop_len,
                       const long long* tops, const long long* lefts,
                       float* out, int scale_to_model_range, int nthreads,
                       char* errbuf, int errbuf_len) {
  if (n <= 0) return 0;
  if (nthreads <= 0) {
    nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 2;
  }
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  const long long item_sz = (long long)mel_num * crop_len;

  auto work = [&]() {
    char err[512];
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      if (load_one(paths[i], mel_num, crop_len, tops[i], lefts[i],
                   out + i * item_sz, scale_to_model_range, err, sizeof(err))) {
        if (!failed.exchange(1) && errbuf && errbuf_len > 0) {
          snprintf(errbuf, errbuf_len, "%s", err);
        }
        return;
      }
    }
  };

  if (nthreads == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }
  return failed.load();
}

// Header-only probe: fills H/W so Python can draw crop offsets without
// np.load'ing the file. Returns 0 on success.
int t2s_npy_shape(const char* path, long long* H, long long* W, char* errbuf,
                  int errbuf_len) {
  FILE* f = fopen(path, "rb");
  if (!f) { snprintf(errbuf, errbuf_len, "%s: open failed", path); return 1; }
  NpyInfo info;
  const int rc = parse_header(f, path, &info, errbuf, errbuf_len);
  fclose(f);
  if (rc) return rc;
  *H = info.H;
  *W = info.W;
  return 0;
}

}  // extern "C"
