// thinkdiff_io: the host-side IO core of the PyTorch port's data loader (a
// copy of native/thinkdiff_io.cc, the JAX package's library, kept apart so
// the port builds and loads its own).
//
// Exposed to Python via ctypes (thinkdiff_torch/data/native.py): tar member
// indexing with O(1) pread sample access, libjpeg decode, fused
// decode+bicubic-resize+CLIP-normalize, and a pthread batch pipeline that
// fills one contiguous float32 HWC array.
//
// Built at first use by thinkdiff_torch/data/native.py with
// g++ -O3 -march=native -shared -fPIC -std=c++17 ... -ljpeg -lpthread.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <atomic>
#include <cmath>
#include <algorithm>

#include <fcntl.h>
#include <unistd.h>

#include <jpeglib.h>
#include <csetjmp>

extern "C" {

// ---------------------------------------------------------------------------
// Tar indexing
// ---------------------------------------------------------------------------

struct TarMember {
  std::string name;
  int64_t offset;  // offset of file DATA (past the 512-byte header)
  int64_t size;
};

struct TarIndex {
  std::string path;
  std::vector<TarMember> members;
};

static int64_t parse_octal(const char* p, size_t n) {
  int64_t v = 0;
  for (size_t i = 0; i < n && p[i]; i++) {
    if (p[i] >= '0' && p[i] <= '7') v = v * 8 + (p[i] - '0');
  }
  return v;
}

void* tdio_open_tar(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* idx = new TarIndex();
  idx->path = path;
  char hdr[512];
  std::string pending_longname;
  int64_t pos = 0;
  while (fread(hdr, 1, 512, f) == 512) {
    pos += 512;
    if (hdr[0] == '\0') break;  // end-of-archive zero block
    int64_t size = parse_octal(hdr + 124, 12);
    char type = hdr[156];
    std::string name(hdr, strnlen(hdr, 100));
    if (type == 'L') {  // GNU long name: data block holds the real name
      std::vector<char> buf(size);
      if (fread(buf.data(), 1, size, f) != (size_t)size) break;
      pending_longname.assign(buf.data(), strnlen(buf.data(), size));
      int64_t pad = (512 - (size % 512)) % 512;
      fseek(f, pad, SEEK_CUR);
      pos += size + pad;
      continue;
    }
    if (!pending_longname.empty()) {
      name = pending_longname;
      pending_longname.clear();
    }
    if (type == '0' || type == '\0') {
      idx->members.push_back({name, pos, size});
    }
    int64_t skip = ((size + 511) / 512) * 512;
    fseek(f, skip, SEEK_CUR);
    pos += skip;
  }
  fclose(f);
  return idx;
}

long tdio_num_members(void* h) {
  return h ? (long)((TarIndex*)h)->members.size() : -1;
}

long tdio_member_info(void* h, long i, int64_t* offset, int64_t* size,
                      char* name_buf, long buf_len) {
  auto* idx = (TarIndex*)h;
  if (!idx || i < 0 || i >= (long)idx->members.size()) return -1;
  const auto& m = idx->members[i];
  *offset = m.offset;
  *size = m.size;
  long n = std::min((long)m.name.size(), buf_len - 1);
  memcpy(name_buf, m.name.data(), n);
  name_buf[n] = '\0';
  return n;
}

void tdio_close_tar(void* h) { delete (TarIndex*)h; }

long tdio_pread(const char* path, int64_t offset, int64_t size,
                unsigned char* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  int64_t done = 0;
  while (done < size) {
    ssize_t r = pread(fd, out + done, size - done, offset + done);
    if (r <= 0) break;
    done += r;
  }
  close(fd);
  return done;
}

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = (JpegErr*)cinfo->err;
  longjmp(err->jb, 1);
}

int tdio_jpeg_info(const unsigned char* data, long size, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return -1; }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode to RGB u8 (row-major HWC). out must hold w*h*3.
int tdio_jpeg_decode(const unsigned char* data, long size, unsigned char* out,
                     int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return -1; }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  int stride = cinfo.output_width * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + (int64_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// Fused decode + bicubic resize + normalize
// ---------------------------------------------------------------------------

static inline float cubic_w(float x) {
  // Catmull-Rom (a = -0.5), PIL BICUBIC kernel
  const float a = -0.5f;
  x = fabsf(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Precompute per-output-pixel antialiased bicubic taps (PIL semantics: the
// kernel support scales with the downscale factor).
struct Taps {
  std::vector<int> start;     // first source index per output pixel
  std::vector<int> count;     // taps per output pixel
  std::vector<float> weights; // concatenated, normalized
  int max_count;
};

static Taps make_taps(int src_n, int dst_n) {
  Taps t;
  float scale = (float)src_n / dst_n;
  float filterscale = std::max(scale, 1.0f);
  float support = 2.0f * filterscale;  // bicubic support = 2
  t.start.resize(dst_n);
  t.count.resize(dst_n);
  t.max_count = 0;
  for (int x = 0; x < dst_n; x++) {
    float center = (x + 0.5f) * scale - 0.5f;
    int lo = std::max(0, (int)floorf(center - support + 0.5f));
    int hi = std::min(src_n, (int)floorf(center + support + 0.5f));
    t.start[x] = lo;
    t.count[x] = hi - lo;
    t.max_count = std::max(t.max_count, hi - lo);
    float wsum = 0;
    size_t base = t.weights.size();
    for (int i = lo; i < hi; i++) {
      float w = cubic_w((i - center) / filterscale);
      t.weights.push_back(w);
      wsum += w;
    }
    if (wsum != 0) {
      for (size_t k = base; k < t.weights.size(); k++) t.weights[k] /= wsum;
    }
  }
  return t;
}

// Separable antialiased-bicubic resize u8 HWC -> f32 HWC with normalize.
static void resize_normalize(const unsigned char* src, int sw, int sh,
                             float* dst, int tw, int th,
                             const float* mean, const float* stdv) {
  Taps tx = make_taps(sw, tw);
  Taps ty = make_taps(sh, th);
  std::vector<float> tmp((int64_t)sh * tw * 3);  // horizontal pass
  {
    // per-x weight offsets precomputed; y outer for cache locality
    std::vector<size_t> woffs(tw);
    size_t woff = 0;
    for (int x = 0; x < tw; x++) { woffs[x] = woff; woff += tx.count[x]; }
    for (int y = 0; y < sh; y++) {
      const unsigned char* row = src + (int64_t)y * sw * 3;
      float* trow = tmp.data() + (int64_t)y * tw * 3;
      for (int x = 0; x < tw; x++) {
        const float* ws = tx.weights.data() + woffs[x];
        int lo = tx.start[x], n = tx.count[x];
        float a0 = 0, a1 = 0, a2 = 0;
        const unsigned char* px = row + (int64_t)lo * 3;
        for (int k = 0; k < n; k++, px += 3) {
          float w = ws[k];
          a0 += w * px[0];
          a1 += w * px[1];
          a2 += w * px[2];
        }
        trow[x * 3 + 0] = a0;
        trow[x * 3 + 1] = a1;
        trow[x * 3 + 2] = a2;
      }
    }
  }
  {
    std::vector<float> acc_row((int64_t)tw * 3);
    size_t woff = 0;
    for (int y = 0; y < th; y++) {
      const float* ws = ty.weights.data() + woff;
      int lo = ty.start[y], n = ty.count[y];
      woff += n;
      std::fill(acc_row.begin(), acc_row.end(), 0.0f);
      for (int k = 0; k < n; k++) {
        float w = ws[k];
        const float* trow = tmp.data() + (int64_t)(lo + k) * tw * 3;
        for (int i = 0; i < tw * 3; i++) acc_row[i] += w * trow[i];
      }
      float* drow = dst + (int64_t)y * tw * 3;
      for (int x = 0; x < tw; x++) {
        for (int c = 0; c < 3; c++) {
          float v = std::clamp(acc_row[x * 3 + c], 0.0f, 255.0f) / 255.0f;
          drow[x * 3 + c] = (v - mean[c]) / stdv[c];
        }
      }
    }
  }
}

// Decode one JPEG and write (target x target x 3) f32 normalized HWC.
int tdio_decode_resize_normalize(const unsigned char* data, long size,
                                 int target, float* out, const float* mean,
                                 const float* stdv) {
  int w, h;
  if (tdio_jpeg_info(data, size, &w, &h) != 0) return -1;
  std::vector<unsigned char> rgb((int64_t)w * h * 3);
  if (tdio_jpeg_decode(data, size, rgb.data(), &w, &h) != 0) return -2;
  resize_normalize(rgb.data(), w, h, out, target, target, mean, stdv);
  return 0;
}

// Batched, threaded version: datas = concatenated buffers with sizes[].
int tdio_decode_batch(const unsigned char* blob, const int64_t* offsets,
                      const int64_t* sizes, int n, int target, float* out,
                      const float* mean, const float* stdv, int nthreads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = tdio_decode_resize_normalize(
          blob + offsets[i], sizes[i], target,
          out + (int64_t)i * target * target * 3, mean, stdv);
      if (rc != 0) failed.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(nthreads, n));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

}  // extern "C"
