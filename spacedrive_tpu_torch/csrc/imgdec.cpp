// Host kernels of the port's image decoder (media/imgdecode.py).
//
// The JAX package decodes images with PIL (spacedrive_tpu/ops/phash.py,
// image_to_grid); the machine with the card has no PIL, so the port decodes
// PNG and BMP itself and must give PIL's 32x32 grid bit for bit. These
// passes run here, each one loop over the pixels with the interpreter lock
// released by ctypes for the call:
//
// - the PNG row unfilter, whose Average and Paeth filters carry a dependency
//   from each byte to the one `bpp` bytes before it, so numpy cannot
//   vectorise them (media/imgdecode.png_unfilter_plain, a Python byte loop,
//   costs about a second per megapixel);
// - PIL's RGB -> L conversion (L24, Convert.c rgb2l) over any pixel layout;
// - the LZW decoder of a GIF frame's image data (media/gif.py; its plain
//   version, lzw_plain, a Python loop over codes);
// - PIL's LANCZOS resample of an L or RGB image to any size (Resample.c:
//   precompute_coeffs, normalize_coeffs_8bpc, the 8bpc horizontal then
//   vertical pass), which touches only each output's taps; the plain
//   versions are imgdecode.resize_lanczos (the pHash grid, a float64 matrix
//   product of the same fixed-point weights) and imgdecode.resize_image;
//   and the same resample of an RGBA image as PIL runs it, premultiplied
//   (RGBA -> RGBa, four bands, RGBa -> RGBA; the SVG rasterizer's canvas,
//   plain version media/draw.resize_rgba);
// - the thumbnailer's conversion of a decoded image to RGB (thumb_rgb).
//
// Built by ops/_build.py with g++ (-ffp-contract=off, so the weights' double
// arithmetic rounds as PIL's does) at first use; called through native.py.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;
constexpr double LANCZOS_SUPPORT = 3.0;

double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

double lanczos_filter(double x) {
  if (-LANCZOS_SUPPORT <= x && x < LANCZOS_SUPPORT)
    return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

// PIL's precompute_coeffs (box = the whole side) + normalize_coeffs_8bpc:
// per output, its first input and tap count in `bounds`, its fixed-point
// weights in `kk` (ksize each). Returns ksize.
int64_t lanczos_coeffs(int64_t in_size, int64_t out_size, std::vector<int64_t>& bounds,
                       std::vector<int32_t>& kk) {
  const double scale = (double)in_size / (double)out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = LANCZOS_SUPPORT * filterscale;
  const int64_t ksize = (int64_t)std::ceil(support) * 2 + 1;
  std::vector<double> k(ksize);
  bounds.assign(out_size * 2, 0);
  kk.assign(out_size * ksize, 0);
  for (int64_t xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int64_t xmin = (int64_t)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int64_t xmax = (int64_t)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int64_t x = 0; x < xmax; ++x) {
      const double w = lanczos_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int64_t x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
      kk[xx * ksize + x] = k[x] < 0 ? (int32_t)(-0.5 + k[x] * (1 << PRECISION_BITS))
                                    : (int32_t)(0.5 + k[x] * (1 << PRECISION_BITS));
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

// An 8-bit pixel times a weight of at most ~1.3 * 2^22, summed, stays
// below 2^31: PIL accumulates in int, and so does this.
inline uint8_t clip8(int32_t in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c);
  const int pb = std::abs(a - c);
  const int pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// `in` holds h rows of 1 + rowbytes bytes (the filter type, then the
// filtered bytes); `out` receives h rows of rowbytes unfiltered bytes.
// `bpp` is the PNG's bytes per complete pixel (1 below 8 bits). Returns 0,
// or 1 + the index of the first row whose filter type is not 0..4.
int64_t sd_png_unfilter(const uint8_t* in, int64_t h, int64_t rowbytes,
                        int64_t bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t kind = in[y * (rowbytes + 1)];
    const uint8_t* src = in + y * (rowbytes + 1) + 1;
    uint8_t* cur = out + y * rowbytes;
    const int64_t lead = bpp < rowbytes ? bpp : rowbytes;
    switch (kind) {
      case 0:
        std::memcpy(cur, src, (size_t)rowbytes);
        break;
      case 1:  // Sub
        std::memcpy(cur, src, (size_t)lead);
        for (int64_t i = bpp; i < rowbytes; ++i)
          cur[i] = (uint8_t)(src[i] + cur[i - bpp]);
        break;
      case 2:  // Up
        if (prev == nullptr) {
          std::memcpy(cur, src, (size_t)rowbytes);
        } else {
          for (int64_t i = 0; i < rowbytes; ++i)
            cur[i] = (uint8_t)(src[i] + prev[i]);
        }
        break;
      case 3:  // Average
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev != nullptr ? prev[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev != nullptr ? prev[i] : 0;
          const int c = (prev != nullptr && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prev = cur;
  }
  return 0;
}

// PIL's rgb2l over h rows of w pixels: `row_stride` bytes between rows,
// `pixel_stride` between pixels, R, G and B at byte offsets r, g, b of a
// pixel. out: [h, w].
void sd_luma(const uint8_t* in, int64_t h, int64_t w, int64_t row_stride,
             int64_t pixel_stride, int64_t r, int64_t g, int64_t b, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = in + y * row_stride;
    uint8_t* dst = out + y * w;
    for (int64_t x = 0; x < w; ++x) {
      const uint8_t* px = row + x * pixel_stride;
      dst[x] = (uint8_t)((px[r] * 19595u + px[g] * 38470u + px[b] * 7471u + 0x8000u) >> 16);
    }
  }
}

// PIL's resize((out_w, out_h), LANCZOS) of an [h, w, c] 8-bit image
// (c interleaved bands: L, or RGB) into out [out_h, out_w, c]: the
// horizontal pass over the rows the vertical pass reads, rounded and
// clipped to uint8 band by band, then the vertical pass. A side that keeps
// its length is not resampled.
void sd_resample_lanczos_image(const uint8_t* in, int64_t h, int64_t w, int64_t c,
                               int64_t out_h, int64_t out_w, uint8_t* out) {
  std::vector<int64_t> bounds_h, bounds_v;
  std::vector<int32_t> kk_h, kk_v;
  const uint8_t* src = in;
  int64_t src_w = w;
  std::vector<uint8_t> tmp;
  int64_t first = 0;  // the first input row the vertical pass reads
  int64_t ksize_v = 0;
  if (h != out_h) ksize_v = lanczos_coeffs(h, out_h, bounds_v, kk_v);
  if (w != out_w) {
    const int64_t ksize_h = lanczos_coeffs(w, out_w, bounds_h, kk_h);
    int64_t last = h;
    if (h != out_h) {
      first = bounds_v[0];
      last = bounds_v[out_h * 2 - 2] + bounds_v[out_h * 2 - 1];
    }
    tmp.resize((size_t)((last - first) * out_w * c));
    for (int64_t y = first; y < last; ++y) {
      const uint8_t* row = in + y * w * c;
      uint8_t* dst = &tmp[(size_t)((y - first) * out_w * c)];
      for (int64_t xx = 0; xx < out_w; ++xx) {
        const int64_t xmin = bounds_h[xx * 2], xmax = bounds_h[xx * 2 + 1];
        const int32_t* k = &kk_h[xx * ksize_h];
        for (int64_t b = 0; b < c; ++b) {
          int32_t ss = 1 << (PRECISION_BITS - 1);
          for (int64_t x = 0; x < xmax; ++x) ss += (int32_t)row[(x + xmin) * c + b] * k[x];
          dst[xx * c + b] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    src_w = out_w;
  }
  if (h == out_h) {
    std::memcpy(out, src, (size_t)(h * src_w * c));
    return;
  }
  const int64_t row_len = src_w * c;
  for (int64_t yy = 0; yy < out_h; ++yy) {
    const int64_t ymin = bounds_v[yy * 2] - first, ymax = bounds_v[yy * 2 + 1];
    const int32_t* k = &kk_v[yy * ksize_v];
    for (int64_t i = 0; i < row_len; ++i) {
      int32_t ss = 1 << (PRECISION_BITS - 1);
      for (int64_t y = 0; y < ymax; ++y) ss += (int32_t)src[(y + ymin) * row_len + i] * k[y];
      out[yy * row_len + i] = clip8(ss);
    }
  }
}

// The pHash grid: PIL's resize((edge, edge), LANCZOS) of an [h, w] L image.
void sd_resample_lanczos(const uint8_t* in, int64_t h, int64_t w, int64_t edge,
                         uint8_t* out) {
  sd_resample_lanczos_image(in, h, w, 1, edge, edge, out);
}

// PIL's resize((out_w, out_h), LANCZOS) of an [h, w, 4] RGBA image: Convert.c
// rgbA2rgba (each colour MULDIV255 by alpha), the four-band resample, then
// rgba2rgbA (255 * c / alpha, truncated and clipped, where alpha is neither
// 0 nor 255). A size that is the image's own is a copy.
void sd_resample_lanczos_rgba(const uint8_t* in, int64_t h, int64_t w, int64_t out_h,
                              int64_t out_w, uint8_t* out) {
  if (h == out_h && w == out_w) {
    std::memcpy(out, in, (size_t)(h * w * 4));
    return;
  }
  std::vector<uint8_t> pre((size_t)(h * w * 4));
  for (int64_t i = 0; i < h * w; ++i) {
    const uint8_t* p = in + i * 4;
    uint8_t* q = &pre[(size_t)(i * 4)];
    for (int b = 0; b < 3; ++b) {
      const uint32_t t = (uint32_t)p[b] * p[3] + 128u;
      q[b] = (uint8_t)(((t >> 8) + t) >> 8);
    }
    q[3] = p[3];
  }
  sd_resample_lanczos_image(pre.data(), h, w, 4, out_h, out_w, out);
  for (int64_t i = 0; i < out_h * out_w; ++i) {
    uint8_t* q = out + i * 4;
    const uint32_t a = q[3];
    if (a == 0 || a == 255) continue;
    for (int b = 0; b < 3; ++b) {
      const uint32_t v = 255u * q[b] / a;
      q[b] = (uint8_t)(v > 255u ? 255u : v);
    }
  }
}

// What the thumbnailer does to a decoded image before its resize
// (media/imgdecode.thumb_rgb): h x w pixels of `c` bytes each (`pixel`
// bytes apart) → out [h, w, 3] RGB. kind 0: gray (band 0 to R, G and B,
// PIL's L/LA to RGB); 1: I;16 (little-endian 16-bit gray, clipped at 255);
// 2: RGB (the first three bands); 3: RGBA composited onto white, PIL's
// paste with an L mask (Paste.c BLEND: DIV255(white·(255 − a) + c·a));
// 4: CMYK, PIL's cmyk2rgb (nk = 255 − K, each band nk − DIV255(c·nk)).
int64_t sd_thumb_rgb(const uint8_t* in, int64_t n, int64_t pixel, int64_t kind,
                     uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = in + i * pixel;
    uint8_t* o = out + i * 3;
    switch (kind) {
      case 0:
        o[0] = o[1] = o[2] = p[0];
        break;
      case 1:
        o[0] = o[1] = o[2] = p[1] ? 255 : p[0];
        break;
      case 2:
        o[0] = p[0], o[1] = p[1], o[2] = p[2];
        break;
      case 3:
        for (int b = 0; b < 3; ++b) {
          const uint32_t t = 255u * (255u - p[3]) + (uint32_t)p[b] * p[3] + 128u;
          o[b] = (uint8_t)(((t >> 8) + t) >> 8);
        }
        break;
      case 4: {
        const int nk = 255 - p[3];
        for (int b = 0; b < 3; ++b) {
          const int t = p[b] * nk + 128;
          const int v = nk - (((t >> 8) + t) >> 8);
          o[b] = (uint8_t)(v < 0 ? 0 : v);
        }
        break;
      }
      default:
        return 1;
    }
  }
  return 0;
}

// GIF LZW: `data` (n bytes, the frame's sub-blocks joined) at minimum code
// size `min_size` -> out[npixels] palette indices, codes read LSB first,
// the code size growing to 12 as the table fills, a full table kept until
// the next clear. Returns 0 once out is full (later codes are not read),
// 1 if the data or an end code comes first, 2 on a code past the table.
int64_t sd_gif_lzw(const uint8_t* data, int64_t n, int64_t min_size, uint8_t* out,
                   int64_t npixels) {
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint8_t stack[4096];
  const int clear = 1 << min_size, end = clear + 1;
  for (int c = 0; c < clear; ++c) {
    suffix[c] = first[c] = (uint8_t)c;
  }
  int size = (int)min_size + 1, next = clear + 2, prev = -1;
  int64_t bitpos = 0, filled = 0;
  while (filled < npixels) {
    if (bitpos + size > 8 * n) return 1;
    uint32_t code = 0;
    for (int b = 0; b < size; ++b, ++bitpos)
      code |= (uint32_t)((data[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
    if ((int)code == clear) {
      size = (int)min_size + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if ((int)code == end) return 1;
    if (prev < 0) {
      if ((int)code > clear) return 2;
      out[filled++] = (uint8_t)code;
      prev = (int)code;
      continue;
    }
    int c = (int)code, top = 0;
    uint8_t head;
    if (c < next) {
      head = first[c];
    } else if (c == next) {
      head = first[prev];
      stack[top++] = head;
      c = prev;
    } else {
      return 2;
    }
    while (c >= clear) {
      stack[top++] = suffix[c];
      c = prefix[c];
    }
    stack[top++] = (uint8_t)c;
    while (top > 0 && filled < npixels) out[filled++] = stack[--top];
    if (next < 4096) {
      prefix[next] = (uint16_t)prev;
      suffix[next] = head;
      first[next] = first[prev];
      ++next;
      if (next == (1 << size) && size < 12) ++size;
    }
    prev = (int)code;
  }
  return 0;
}

}  // extern "C"
