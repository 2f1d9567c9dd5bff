// Native image decode + crop + resample for the data loader hot path.
//
// TPU-native framework runtime component (SURVEY.md §2.9: the reference's
// data path rides torch DataLoader worker *processes* + PIL's C decoders;
// here a C++ thread pool feeds pinned uint8 batches with zero GIL
// involvement). Capabilities:
//   - JPEG (libjpeg, incl. DCT-domain scaled decode: when the target is
//     much smaller than the source the IDCT runs at 1/2, 1/4 or 1/8 scale,
//     skipping most of the decode work), grayscale/CMYK/YCCK handled
//   - PNG (libpng simplified API), WebP (libwebp)
//   - crop + separable antialiased resample (PIL-equivalent triangle /
//     Catmull-Rom kernels incl. the downscale support widening) + hflip
//   - a pthread pool with a batched API: one call decodes a whole batch
//     into a caller-provided contiguous (N, H, W, 3) uint8 buffer
//
// C ABI only (consumed via ctypes from simseg_tpu/data/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <webp/decode.h>

namespace {

struct ImageU8 {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

// ---------------------------------------------------------------- JPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool is_jpeg(const uint8_t* buf, size_t len) {
  return len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}

bool is_png(const uint8_t* buf, size_t len) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};
  return len >= 8 && memcmp(buf, sig, 8) == 0;
}

bool is_webp(const uint8_t* buf, size_t len) {
  return len >= 12 && memcmp(buf, "RIFF", 4) == 0 && memcmp(buf + 8, "WEBP", 4) == 0;
}

// decode JPEG; if min_w/min_h > 0, the decoder may pick a DCT scale
// (1/2, 1/4, 1/8) as long as the result still covers min_w x min_h.
bool decode_jpeg(const uint8_t* buf, size_t len, int min_w, int min_h,
                 ImageU8* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  std::vector<uint8_t> row_cmyk;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const bool cmyk = cinfo.jpeg_color_space == JCS_CMYK ||
                    cinfo.jpeg_color_space == JCS_YCCK;
  const bool adobe_inverted = cinfo.saw_Adobe_marker;  // PIL convention
  if (!cmyk) cinfo.out_color_space = JCS_RGB;

  if (min_w > 0 && min_h > 0) {
    // largest denom in {8,4,2} whose output still covers the target
    for (unsigned denom = 8; denom >= 2; denom /= 2) {
      if ((int)(cinfo.image_width / denom) >= min_w &&
          (int)(cinfo.image_height / denom) >= min_h) {
        cinfo.scale_num = 1;
        cinfo.scale_denom = denom;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize((size_t)out->w * out->h * 3);
  if (cmyk) row_cmyk.resize((size_t)out->w * 4);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out->rgb.data() + (size_t)cinfo.output_scanline * out->w * 3;
    if (cmyk) {
      uint8_t* rp = row_cmyk.data();
      jpeg_read_scanlines(&cinfo, &rp, 1);
      for (int x = 0; x < out->w; x++) {
        int c = rp[4 * x], m = rp[4 * x + 1], y = rp[4 * x + 2], k = rp[4 * x + 3];
        if (!adobe_inverted) { c = 255 - c; m = 255 - m; y = 255 - y; k = 255 - k; }
        dst[3 * x] = (uint8_t)(c * k / 255);
        dst[3 * x + 1] = (uint8_t)(m * k / 255);
        dst[3 * x + 2] = (uint8_t)(y * k / 255);
      }
    } else {
      jpeg_read_scanlines(&cinfo, &dst, 1);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool jpeg_size(const uint8_t* buf, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  bool ok = jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK;
  if (ok) {
    *w = cinfo.image_width;
    *h = cinfo.image_height;
  }
  jpeg_destroy_decompress(&cinfo);
  return ok;
}

// ---------------------------------------------------------------- PNG

bool decode_png(const uint8_t* buf, size_t len, ImageU8* out) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, buf, len)) return false;
  // read RGBA and strip the alpha channel: PIL's convert('RGB') DROPS
  // alpha, while libpng's PNG_FORMAT_RGB would composite it away (a
  // transparent red pixel must stay red, not turn black)
  image.format = PNG_FORMAT_RGBA;
  out->w = image.width;
  out->h = image.height;
  std::vector<uint8_t> rgba(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, rgba.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  out->rgb.resize((size_t)out->w * out->h * 3);
  const size_t n = (size_t)out->w * out->h;
  for (size_t i = 0; i < n; i++) {
    out->rgb[3 * i] = rgba[4 * i];
    out->rgb[3 * i + 1] = rgba[4 * i + 1];
    out->rgb[3 * i + 2] = rgba[4 * i + 2];
  }
  return true;
}

bool png_size(const uint8_t* buf, size_t len, int* w, int* h) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, buf, len)) return false;
  *w = image.width;
  *h = image.height;
  png_image_free(&image);
  return true;
}

// ---------------------------------------------------------------- WebP

bool decode_webp(const uint8_t* buf, size_t len, ImageU8* out) {
  int w, h;
  if (!WebPGetInfo(buf, len, &w, &h)) return false;
  out->w = w;
  out->h = h;
  out->rgb.resize((size_t)w * h * 3);
  return WebPDecodeRGBInto(buf, len, out->rgb.data(), out->rgb.size(), w * 3) !=
         nullptr;
}

// ---------------------------------------------------------------- resample

// PIL-equivalent separable resampler: coefficients follow PIL's
// precompute_coeffs (antialias: kernel support widens by the downscale
// factor), float accumulation, round-half-away like PIL's fixed point.
struct Kernel {
  double support;
  std::function<double(double)> f;
};

Kernel triangle_kernel() {
  return {1.0, [](double x) {
            x = std::fabs(x);
            return x < 1.0 ? 1.0 - x : 0.0;
          }};
}

Kernel bicubic_kernel() {  // PIL BICUBIC: Catmull-Rom-like, a = -0.5
  return {2.0, [](double x) {
            constexpr double a = -0.5;
            x = std::fabs(x);
            if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
            if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
            return 0.0;
          }};
}

struct Coeffs {
  int ksize;                 // taps per output element
  std::vector<int> bounds;   // out_size * 2: (first, count)
  std::vector<double> coef;  // out_size * ksize
};

Coeffs precompute(int in_size, int out_size, double c0, double c1,
                  const Kernel& k) {
  // c0..c1: source window (crop support in source coords). Taps clamp to
  // the window (not the full image) to match PIL's crop-then-resize, which
  // renormalizes edge kernels over the cropped extent only.
  Coeffs c;
  double scale = (c1 - c0) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = k.support * filterscale;
  int lo = std::max(0, (int)std::floor(c0));
  int hi = std::min(in_size, (int)std::ceil(c1));
  c.ksize = (int)std::ceil(support) * 2 + 1;
  c.bounds.resize(out_size * 2);
  c.coef.resize((size_t)out_size * c.ksize);
  for (int i = 0; i < out_size; i++) {
    double center = c0 + (i + 0.5) * scale;
    int xmin = (int)std::max((double)lo, std::floor(center - support));
    int xmax = std::min(hi, (int)std::ceil(center + support));
    double* w = &c.coef[(size_t)i * c.ksize];
    double total = 0.0;
    int n = xmax - xmin;
    for (int x = 0; x < n; x++) {
      double v = k.f((x + xmin - center + 0.5) / filterscale);
      w[x] = v;
      total += v;
    }
    if (total != 0.0)
      for (int x = 0; x < n; x++) w[x] /= total;
    c.bounds[2 * i] = xmin;
    c.bounds[2 * i + 1] = n;
  }
  return c;
}

inline uint8_t clip8(double v) {
  return (uint8_t)std::min(255.0, std::max(0.0, v + 0.5));
}

// resample src (h, w, 3) region [crop] to (out_h, out_w, 3)
void resample(const ImageU8& src, double cx, double cy, double cw, double ch,
              int out_w, int out_h, int filter, std::vector<uint8_t>* dst) {
  Kernel k = filter == 1 ? bicubic_kernel() : triangle_kernel();
  if (filter == 2) {  // nearest
    dst->resize((size_t)out_w * out_h * 3);
    for (int y = 0; y < out_h; y++) {
      int sy = std::min(src.h - 1, (int)(cy + (y + 0.5) * ch / out_h));
      for (int x = 0; x < out_w; x++) {
        int sx = std::min(src.w - 1, (int)(cx + (x + 0.5) * cw / out_w));
        memcpy(&(*dst)[((size_t)y * out_w + x) * 3],
               &src.rgb[((size_t)sy * src.w + sx) * 3], 3);
      }
    }
    return;
  }
  Coeffs hc = precompute(src.w, out_w, cx, cx + cw, k);
  Coeffs vc = precompute(src.h, out_h, cy, cy + ch, k);

  // horizontal pass; the intermediate quantizes to uint8 like PIL's
  // per-pass fixed-point path (bicubic's negative lobes overshoot and PIL
  // clamps between passes — skipping this drifts >1 LSB from PIL). Only
  // rows inside the vertical support range are produced.
  int row0 = vc.bounds[0];
  int row1 = vc.bounds[2 * (out_h - 1)] + vc.bounds[2 * (out_h - 1) + 1];
  int tmp_h = row1 - row0;
  std::vector<uint8_t> tmp((size_t)tmp_h * out_w * 3);
  for (int y = 0; y < tmp_h; y++) {
    const uint8_t* srow = &src.rgb[(size_t)(y + row0) * src.w * 3];
    uint8_t* trow = &tmp[(size_t)y * out_w * 3];
    for (int x = 0; x < out_w; x++) {
      const double* w = &hc.coef[(size_t)x * hc.ksize];
      int xmin = hc.bounds[2 * x], n = hc.bounds[2 * x + 1];
      double r = 0, g = 0, b = 0;
      for (int i = 0; i < n; i++) {
        const uint8_t* p = &srow[(size_t)(xmin + i) * 3];
        r += p[0] * w[i];
        g += p[1] * w[i];
        b += p[2] * w[i];
      }
      trow[3 * x] = clip8(r);
      trow[3 * x + 1] = clip8(g);
      trow[3 * x + 2] = clip8(b);
    }
  }
  // vertical pass
  dst->resize((size_t)out_w * out_h * 3);
  for (int y = 0; y < out_h; y++) {
    const double* w = &vc.coef[(size_t)y * vc.ksize];
    int ymin = vc.bounds[2 * y] - row0, n = vc.bounds[2 * y + 1];
    uint8_t* drow = &(*dst)[(size_t)y * out_w * 3];
    for (int x = 0; x < out_w * 3; x++) {
      double acc = 0;
      for (int i = 0; i < n; i++)
        acc += tmp[(size_t)(ymin + i) * out_w * 3 + x] * w[i];
      drow[x] = clip8(acc);
    }
  }
}

// ---------------------------------------------------------------- decode+op

int decode_one(const uint8_t* buf, size_t len, int crop_x, int crop_y,
               int crop_w, int crop_h, int out_w, int out_h, int flip,
               int filter, int fast_scale, uint8_t* out) {
  ImageU8 img;
  bool full = crop_w <= 0 || crop_h <= 0;
  int orig_w = 0, orig_h = 0;
  if (is_jpeg(buf, len)) {
    if (!jpeg_size(buf, len, &orig_w, &orig_h)) return 1;
    int min_w = 0, min_h = 0;
    if (fast_scale && out_w > 0) {
      // the decoded crop region must still cover the output resolution:
      // scaled_crop_w >= out_w  <=>  scaled_w >= out_w * (w / crop_w)
      double cw = full ? orig_w : crop_w, ch = full ? orig_h : crop_h;
      min_w = (int)std::ceil(out_w * orig_w / cw);
      min_h = (int)std::ceil(out_h * orig_h / ch);
    }
    if (!decode_jpeg(buf, len, min_w, min_h, &img)) return 1;
  } else if (is_png(buf, len)) {
    if (!decode_png(buf, len, &img)) return 1;
    orig_w = img.w;
    orig_h = img.h;
  } else if (is_webp(buf, len)) {
    if (!decode_webp(buf, len, &img)) return 1;
    orig_w = img.w;
    orig_h = img.h;
  } else {
    return 2;  // unknown format
  }
  // crop box given in ORIGINAL coordinates; rescale to the decoded grid
  double sx = (double)img.w / orig_w, sy = (double)img.h / orig_h;
  double cx = full ? 0.0 : crop_x * sx;
  double cy = full ? 0.0 : crop_y * sy;
  double cw = full ? (double)img.w : crop_w * sx;
  double ch = full ? (double)img.h : crop_h * sy;
  cx = std::min(std::max(cx, 0.0), (double)img.w);
  cy = std::min(std::max(cy, 0.0), (double)img.h);
  cw = std::min(cw, img.w - cx);
  ch = std::min(ch, img.h - cy);
  if (out_w <= 0) {
    out_w = (int)std::lround(cw);
    out_h = (int)std::lround(ch);
  }
  std::vector<uint8_t> res;
  resample(img, cx, cy, cw, ch, out_w, out_h, filter, &res);
  if (flip) {
    for (int y = 0; y < out_h; y++) {
      uint8_t* row = res.data() + (size_t)y * out_w * 3;
      for (int x = 0; x < out_w / 2; x++) {
        for (int c = 0; c < 3; c++)
          std::swap(row[3 * x + c], row[3 * (out_w - 1 - x) + c]);
      }
    }
  }
  memcpy(out, res.data(), res.size());
  return 0;
}

// ---------------------------------------------------------------- pool

struct Pool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> jobs;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; i++)
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !jobs.empty(); });
            if (stop && jobs.empty()) return;
            job = std::move(jobs.front());
            jobs.pop();
          }
          job();
        }
      });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : workers) t.join();
  }

  // Per-batch completion state (not a pool-global pending count): two
  // threads sharing one pool each wait only for their own batch, and are
  // not woken by the other caller's completions.
  void run_all(std::vector<std::function<void()>> batch) {
    if (batch.empty()) return;
    struct BatchState {
      std::mutex mu;
      std::condition_variable cv;
      int remaining;
    };
    auto state = std::make_shared<BatchState>();
    state->remaining = (int)batch.size();
    {
      std::lock_guard<std::mutex> lk(mu);
      for (auto& j : batch)
        jobs.push([state, job = std::move(j)] {
          job();
          std::lock_guard<std::mutex> lk(state->mu);
          if (--state->remaining == 0) state->cv.notify_all();
        });
    }
    cv.notify_all();
    std::unique_lock<std::mutex> lk(state->mu);
    state->cv.wait(lk, [&] { return state->remaining == 0; });
  }
};

}  // namespace

extern "C" {

int ssd_image_size(const uint8_t* buf, size_t len, int* w, int* h) {
  if (is_jpeg(buf, len)) return jpeg_size(buf, len, w, h) ? 0 : 1;
  if (is_png(buf, len)) return png_size(buf, len, w, h) ? 0 : 1;
  if (is_webp(buf, len)) return WebPGetInfo(buf, len, w, h) ? 0 : 1;
  return 2;
}

int ssd_decode(const uint8_t* buf, size_t len, int crop_x, int crop_y,
               int crop_w, int crop_h, int out_w, int out_h, int flip,
               int filter, int fast_scale, uint8_t* out) {
  return decode_one(buf, len, crop_x, crop_y, crop_w, crop_h, out_w, out_h,
                    flip, filter, fast_scale, out);
}

void* ssd_pool_new(int threads) { return new Pool(std::max(1, threads)); }

void ssd_pool_free(void* pool) { delete static_cast<Pool*>(pool); }

// decode n images into out (n, out_h, out_w, 3); crops: n*4 ints
// (x, y, w, h; w<=0 => full image); flips: n ints; status: n ints (0 = ok)
int ssd_pool_decode_batch(void* pool, int n, const uint8_t** bufs,
                          const size_t* lens, const int* crops, int out_w,
                          int out_h, const int* flips, int filter,
                          int fast_scale, uint8_t* out, int* status) {
  Pool* p = static_cast<Pool*>(pool);
  std::vector<std::function<void()>> jobs;
  jobs.reserve(n);
  size_t stride = (size_t)out_w * out_h * 3;
  for (int i = 0; i < n; i++) {
    jobs.push_back([=] {
      status[i] = decode_one(bufs[i], lens[i], crops[4 * i], crops[4 * i + 1],
                             crops[4 * i + 2], crops[4 * i + 3], out_w, out_h,
                             flips[i], filter, fast_scale, out + stride * i);
    });
  }
  p->run_all(std::move(jobs));
  int rc = 0;
  for (int i = 0; i < n; i++)
    if (status[i] != 0) rc = 1;
  return rc;
}

}  // extern "C"
