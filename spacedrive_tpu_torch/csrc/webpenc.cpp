// The thumbnailer's lossy WebP encoder: one VP8 key frame of an RGB image
// (media/webpenc.py is the plain version and holds the parameters).
//
// The JAX package thumbnails through PIL, whose WebP encoder is libwebp's at
// quality 30; the machine with the card has no PIL, so the port writes its
// own key frame, which any VP8 decoder reads. Every step is integer
// arithmetic, so this file and its plain version give the same bytes:
//
// - RGB to YUV 4:2:0 with libwebp's fixed-point BT.601 (VP8RGBToY/U/V; U
//   and V from the sum of each 2x2 block), the edges replicated out to whole
//   macroblocks;
// - per macroblock, the 16x16 luma and 8x8 chroma prediction (DC with its
//   edge forms, TM, V, H; the decoder's 127/129 borders) with the least sum
//   of squared errors, ties to the lower mode number;
// - libwebp's forward DCT and WHT (FTransform, FTransformWHT), its
//   quantiser (QUANTDIV with the 96/110, 96/108 and 110/115 biases, the
//   zero thresholds, the frequency sharpening of luma AC), and the
//   decoder's dequantisation, inverse WHT and DCT (TransformOne) to
//   reconstruct, so prediction reads what the decoder will hold;
// - the tokens (RFC 6386 section 13) with their contexts, recorded first;
//   each coefficient probability is then replaced where the saving in bits
//   pays for the update (libwebp's FinalizeTokenProbas rule, costs from an
//   integer table the caller passes), the skip flag used where it pays;
// - the boolean encoder (RFC 6386 section 7.3), one token partition.
//
// Built by spacedrive_tpu_torch/ops/_build.py with g++ into a shared library
// with a plain C interface (ctypes); the tables come from the caller
// (media/webp_tables.py), so both versions read the same ones.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr int kFreqSharpening[16] = {0, 30, 60, 90, 30, 60, 90, 90,
                                     60, 90, 90, 90, 90, 90, 90, 90};
constexpr int kBias[3][2] = {{96, 110}, {96, 108}, {110, 115}};  // y1, y2, uv
constexpr int QFIX = 17;
constexpr int MAX_LEVEL = 2047;
constexpr int kCat[4][11] = {{173, 148, 140}, {176, 155, 140, 135},
                             {180, 157, 141, 134, 130},
                             {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129}};
constexpr int kCatLen[4] = {3, 4, 5, 11};

struct Matrix {
  int q[16], iq[16], bias[16], zthresh[16], sharpen[16];
};

void make_matrix(Matrix& m, int dc, int ac, int type) {
  for (int i = 0; i < 16; ++i) {
    const int is_ac = i > 0;
    m.q[i] = is_ac ? ac : dc;
    m.iq[i] = (1 << QFIX) / m.q[i];
    m.bias[i] = kBias[type][is_ac] << (QFIX - 8);
    m.zthresh[i] = ((1 << QFIX) - 1 - m.bias[i]) / m.iq[i];
    m.sharpen[i] = type == 0 ? (kFreqSharpening[i] * m.q[i]) >> 11 : 0;
  }
}

inline int wrap16(int v) { return (int)(int16_t)(uint16_t)(v & 0xffff); }

// Raster coefficients `in` → zigzag levels `out` (from `first`) and the
// dequantised raster coefficients `deq` the decoder will hold.
void quantize(const int* in, const Matrix& m, int first, int* out, int* deq) {
  for (int n = 0; n < 16; ++n) {
    out[n] = 0;
    deq[n] = 0;
  }
  for (int n = first; n < 16; ++n) {
    const int j = kZigzag[n];
    const int sign = in[j] < 0;
    const int coeff = (sign ? -in[j] : in[j]) + m.sharpen[j];
    if (coeff > m.zthresh[j]) {
      int level = (int)(((int64_t)coeff * m.iq[j] + m.bias[j]) >> QFIX);
      if (level > MAX_LEVEL) level = MAX_LEVEL;
      if (sign) level = -level;
      out[n] = level;
      deq[j] = wrap16(level * m.q[j]);
    }
  }
}

// libwebp's FTransform of src - ref, 4x4 (row-major, `stride` apart).
void ftransform(const int* src, const int* ref, int stride, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int* s = src + i * stride;
    const int* r = ref + i * stride;
    const int d0 = s[0] - r[0], d1 = s[1] - r[1], d2 = s[2] - r[2], d3 = s[3] - r[3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = (a0 + a1 + 7) >> 4;
    out[4 + i] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0);
    out[8 + i] = (a0 - a1 + 7) >> 4;
    out[12 + i] = (a3 * 2217 - a2 * 5352 + 51000) >> 16;
  }
}

// FTransformWHT of the 16 blocks' DCs (dc[k], raster block order).
void fwht(const int* dc, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int* in = dc + 4 * i;
    const int a0 = in[0] + in[2], a1 = in[1] + in[3], a2 = in[1] - in[3], a3 = in[0] - in[2];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    out[0 + i] = (a0 + a1) >> 1;
    out[4 + i] = (a3 + a2) >> 1;
    out[8 + i] = (a3 - a2) >> 1;
    out[12 + i] = (a0 - a1) >> 1;
  }
}

// The decoder's TransformWHT: raster Y2 coefficients → the 16 blocks' DCs.
void iwht(const int* in, int* dc) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int d = tmp[0 + i * 4] + 3;
    const int a0 = d + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = d - tmp[3 + i * 4];
    dc[4 * i + 0] = wrap16((a0 + a1) >> 3);
    dc[4 * i + 1] = wrap16((a3 + a2) >> 3);
    dc[4 * i + 2] = wrap16((a0 - a1) >> 3);
    dc[4 * i + 3] = wrap16((a3 - a2) >> 3);
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// The decoder's TransformOne: `pred` + the residual of `in` → `dst`.
void itransform(const int* in, const int* pred, int stride, int* dst) {
  int t[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    t[i * 4 + 0] = a + d;
    t[i * 4 + 1] = b + c;
    t[i * 4 + 2] = b - c;
    t[i * 4 + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = t[i] + 4;
    const int a = dc + t[8 + i], b = dc - t[8 + i];
    const int c = mul2(t[4 + i]) - mul1(t[12 + i]);
    const int d = mul1(t[4 + i]) + mul2(t[12 + i]);
    const int v[4] = {a + d, b + c, b - c, a - d};
    for (int k = 0; k < 4; ++k)
      dst[i * stride + k] = clip8(pred[i * stride + k] + (v[k] >> 3));
  }
}

struct Plane {
  int w = 0, h = 0;
  std::vector<int> v;
  int& at(int y, int x) { return v[(size_t)y * w + x]; }
};

// The four predictions (DC, TM, V, H) of the size x size block at (mx, my)
// of the reconstruction `rec`: pred[mode][size * size].
void predict(Plane& rec, int mx, int my, int size, std::vector<int>* pred) {
  const int y0 = my * size, x0 = mx * size;
  int top[16], left[16];
  for (int k = 0; k < size; ++k) {
    top[k] = my > 0 ? rec.at(y0 - 1, x0 + k) : 127;
    left[k] = mx > 0 ? rec.at(y0 + k, x0 - 1) : 129;
  }
  const int tl = my == 0 ? 127 : mx == 0 ? 129 : rec.at(y0 - 1, x0 - 1);
  const int shift = size == 16 ? 4 : 3;
  int st = 0, sl = 0;
  for (int k = 0; k < size; ++k) st += top[k], sl += left[k];
  int dc;
  if (my > 0 && mx > 0) dc = (st + sl + size) >> (shift + 1);
  else if (mx > 0) dc = (sl + (size >> 1)) >> shift;
  else if (my > 0) dc = (st + (size >> 1)) >> shift;
  else dc = 0x80;
  for (int m = 0; m < 4; ++m) pred[m].assign(size * size, 0);
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x) {
      pred[0][y * size + x] = dc;
      pred[1][y * size + x] = clip8(top[x] + left[y] - tl);
      pred[2][y * size + x] = top[x];
      pred[3][y * size + x] = left[y];
    }
}

int64_t sse(Plane& src, int mx, int my, int size, const std::vector<int>& pred) {
  int64_t s = 0;
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x) {
      const int d = src.at(my * size + y, mx * size + x) - pred[y * size + x];
      s += (int64_t)d * d;
    }
  return s;
}

struct MB {
  int ymode, uvmode;
  int y2[16], y[16][16], u[4][16], v[4][16];  // zigzag levels
  bool skip;
};

// A token: a bit coded with coefficient probability `slot` (0..1055), or
// with the fixed probability `fixed` where slot < 0.
struct Token {
  int16_t slot;
  uint8_t fixed, bit;
};

struct Tokens {
  std::vector<Token> t;
  void put(int bit, int slot) { t.push_back({(int16_t)slot, 0, (uint8_t)bit}); }
  void fixed(int bit, int prob) { t.push_back({-1, (uint8_t)prob, (uint8_t)bit}); }
};

inline int slot_of(int type, int n, int ctx) { return ((type * 8 + kBands[n]) * 3 + ctx) * 11; }

// One block's tokens (GetCoeffs' inverse); returns whether it has a
// non-zero level from `first` on (the decoder's nz).
int block_tokens(Tokens& tk, int type, int ctx, const int* zz, int first) {
  int n = first;
  int p = slot_of(type, n, ctx);
  int last = -1;
  for (int k = first; k < 16; ++k)
    if (zz[k]) last = k;
  if (last < 0) {
    tk.put(0, p + 0);
    return 0;
  }
  while (n < 16) {
    if (n > last) {
      tk.put(0, p + 0);
      return 1;
    }
    tk.put(1, p + 0);
    while (zz[n] == 0) {
      tk.put(0, p + 1);
      ++n;
      p = slot_of(type, n, 0);
    }
    tk.put(1, p + 1);
    const int v = std::abs(zz[n]);
    if (v == 1) {
      tk.put(0, p + 2);
      p = slot_of(type, n + 1, 1);
    } else {
      tk.put(1, p + 2);
      if (v <= 4) {
        tk.put(0, p + 3);
        if (v == 2) {
          tk.put(0, p + 4);
        } else {
          tk.put(1, p + 4);
          tk.put(v - 3, p + 5);
        }
      } else if (v <= 10) {
        tk.put(1, p + 3);
        tk.put(0, p + 6);
        if (v <= 6) {
          tk.put(0, p + 7);
          tk.fixed(v - 5, 159);
        } else {
          tk.put(1, p + 7);
          tk.fixed((v - 7) >> 1, 165);
          tk.fixed((v - 7) & 1, 145);
        }
      } else {
        tk.put(1, p + 3);
        tk.put(1, p + 6);
        const int cat = v < 19 ? 0 : v < 35 ? 1 : v < 67 ? 2 : 3;
        tk.put(cat >> 1, p + 8);
        tk.put(cat & 1, p + 9 + (cat >> 1));
        const int extra = v - (3 + (8 << cat));
        for (int k = 0; k < kCatLen[cat]; ++k)
          tk.fixed((extra >> (kCatLen[cat] - 1 - k)) & 1, kCat[cat][k]);
      }
      p = slot_of(type, n + 1, 2);
    }
    tk.fixed(zz[n] < 0, 128);
    ++n;
  }
  return 1;
}

// ParseResiduals' inverse for an i16 macroblock; `top` and `left` are the
// non-zero context bits: [0] 4 luma + 2x2 U + 2x2 V columns/rows, [1] Y2.
void mb_tokens(Tokens& tk, const MB& mb, int* top, int* left) {
  const int nz2 = block_tokens(tk, 1, top[1] + left[1], mb.y2, 0);
  top[1] = left[1] = nz2;
  int tnz = top[0] & 0x0f, lnz = left[0] & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    for (int x = 0; x < 4; ++x) {
      const int nz = block_tokens(tk, 0, l + (tnz & 1), mb.y[4 * y + x], 1);
      l = nz;
      tnz = (tnz >> 1) | (l << 7);
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
  }
  int out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    const int (*blocks)[16] = ch == 0 ? mb.u : mb.v;
    tnz = (top[0] >> (4 + ch)) & 0xff;
    lnz = (left[0] >> (4 + ch)) & 0xff;
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int nz = block_tokens(tk, 2, l + (tnz & 1), blocks[2 * y + x], 0);
        l = nz;
        tnz = (tnz >> 1) | (l << 3);
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    out_t |= (tnz << 4) << ch;
    out_l |= (lnz & 0xf0) << ch;
  }
  top[0] = out_t & 0xff;
  left[0] = out_l & 0xff;
}

struct BoolWriter {
  std::vector<uint8_t> out;
  uint32_t range = 255, bottom = 0;
  int count = 24;
  void carry() {
    size_t i = out.size();
    while (i > 0 && out[i - 1] == 255) out[--i] = 0;
    if (i > 0) ++out[i - 1];
  }
  void put(int bit, int prob) {
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    if (bit) {
      bottom += split;
      range -= split;
    } else {
      range = split;
    }
    while (range < 128) {
      range <<= 1;
      if (bottom & (1u << 31)) carry();
      bottom <<= 1;
      if (!--count) {
        out.push_back((uint8_t)(bottom >> 24));
        bottom &= (1u << 24) - 1;
        count = 8;
      }
    }
  }
  void bits(int value, int n) {
    for (int k = n - 1; k >= 0; --k) put((value >> k) & 1, 0x80);
  }
  void finish() {
    uint32_t v = bottom;
    const int c = count;
    if (c < 32 && (v & (1u << (32 - c)))) carry();
    v <<= (c & 7);
    for (int k = 0; k < (c >> 3); ++k) v <<= 8;
    for (int k = 0; k < 4; ++k) {
      out.push_back((uint8_t)(v >> 24));
      v <<= 8;
    }
  }
};

inline int64_t bit_cost(const int* cost, int bit, int prob) {
  return bit ? cost[255 - prob] : cost[prob];
}

}  // namespace

extern "C" {

// [h][w][3] RGB → a VP8 key frame (the payload of a "VP8 " chunk) in out
// (cap bytes). q: the quantiser index; uv_dc: the chroma DC delta; level:
// the normal loop filter's level; dc_table, ac_table [128]; proba0,
// update_proba [1056] (the default coefficient probabilities and their
// update probabilities, [4][8][3][11]); cost [256]: a bit's cost at
// probability p/256 in 1/256 bits. Returns the frame's size, or -1 where
// cap is too small.
int64_t sd_webp_encode(const uint8_t* rgb, int64_t h, int64_t w, int64_t q, int64_t uv_dc,
                       int64_t level, const int64_t* dc_table, const int64_t* ac_table,
                       const int64_t* proba0, const int64_t* update_proba, const int64_t* cost64,
                       uint8_t* out, int64_t cap) {
  const int mb_w = (int)((w + 15) >> 4), mb_h = (int)((h + 15) >> 4);
  int cost[256];
  for (int k = 0; k < 256; ++k) cost[k] = (int)cost64[k];
  // RGB → Y, U, V over the padded picture.
  Plane Y, U, V, RY, RU, RV;
  Y.w = RY.w = 16 * mb_w, Y.h = RY.h = 16 * mb_h;
  U.w = V.w = RU.w = RV.w = 8 * mb_w, U.h = V.h = RU.h = RV.h = 8 * mb_h;
  Y.v.assign((size_t)Y.w * Y.h, 0), RY.v = Y.v;
  U.v.assign((size_t)U.w * U.h, 0), V.v = RU.v = RV.v = U.v;
  auto px = [&](int y, int x, int c) {
    const int64_t yy = y < h ? y : h - 1, xx = x < w ? x : w - 1;
    return (int)rgb[(yy * w + xx) * 3 + c];
  };
  for (int y = 0; y < Y.h; ++y)
    for (int x = 0; x < Y.w; ++x)
      Y.at(y, x) = (16839 * px(y, x, 0) + 33059 * px(y, x, 1) + 6420 * px(y, x, 2) +
                    (16 << 16) + (1 << 15)) >> 16;
  for (int y = 0; y < U.h; ++y)
    for (int x = 0; x < U.w; ++x) {
      int r = 0, g = 0, b = 0;
      for (int dy = 0; dy < 2; ++dy)
        for (int dx = 0; dx < 2; ++dx) {
          r += px(2 * y + dy, 2 * x + dx, 0);
          g += px(2 * y + dy, 2 * x + dx, 1);
          b += px(2 * y + dy, 2 * x + dx, 2);
        }
      const int u = (-9719 * r - 19081 * g + 28800 * b + (1 << 17) + (128 << 18)) >> 18;
      const int v = (28800 * r - 24116 * g - 4684 * b + (1 << 17) + (128 << 18)) >> 18;
      U.at(y, x) = clip8(u);
      V.at(y, x) = clip8(v);
    }
  auto clipq = [](int64_t v, int64_t hi) { return (int)(v < 0 ? 0 : v > hi ? hi : v); };
  Matrix my1, my2, muv;
  make_matrix(my1, (int)dc_table[q], (int)ac_table[q], 0);
  const int y2ac = (int)((ac_table[q] * 101581) >> 16);
  make_matrix(my2, (int)dc_table[q] * 2, y2ac < 8 ? 8 : y2ac, 1);
  make_matrix(muv, (int)dc_table[clipq(q + uv_dc, 117)], (int)ac_table[q], 2);

  // Reconstruct and tokenize, macroblock by macroblock.
  std::vector<MB> mbs((size_t)mb_w * mb_h);
  std::vector<int> pred[4], upred[4], vpred[4];
  int src[256], coef[16][16], dcs[16], y2c[16], y2deq[16], dcout[16], deq[16], rec[256];
  for (int my = 0; my < mb_h; ++my)
    for (int mx = 0; mx < mb_w; ++mx) {
      MB& mb = mbs[(size_t)my * mb_w + mx];
      predict(RY, mx, my, 16, pred);
      int best = 0;
      int64_t best_e = sse(Y, mx, my, 16, pred[0]);
      for (int m = 1; m < 4; ++m) {
        const int64_t e = sse(Y, mx, my, 16, pred[m]);
        if (e < best_e) best = m, best_e = e;
      }
      mb.ymode = best;
      const std::vector<int>& p = pred[best];
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) src[y * 16 + x] = Y.at(16 * my + y, 16 * mx + x);
      for (int k = 0; k < 16; ++k) {
        const int off = (k >> 2) * 64 + (k & 3) * 4;
        ftransform(src + off, p.data() + off, 16, coef[k]);
        dcs[k] = coef[k][0];
      }
      fwht(dcs, y2c);
      quantize(y2c, my2, 0, mb.y2, y2deq);
      iwht(y2deq, dcout);
      bool any = false;
      for (int k = 0; k < 16; ++k) any |= mb.y2[k] != 0;
      for (int k = 0; k < 16; ++k) {
        const int off = (k >> 2) * 64 + (k & 3) * 4;
        quantize(coef[k], my1, 1, mb.y[k], deq);
        for (int n = 0; n < 16; ++n) any |= mb.y[k][n] != 0;
        deq[0] = dcout[k];
        itransform(deq, p.data() + off, 16, rec + off);
      }
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) RY.at(16 * my + y, 16 * mx + x) = rec[y * 16 + x];
      predict(RU, mx, my, 8, upred);
      predict(RV, mx, my, 8, vpred);
      best = 0;
      best_e = sse(U, mx, my, 8, upred[0]) + sse(V, mx, my, 8, vpred[0]);
      for (int m = 1; m < 4; ++m) {
        const int64_t e = sse(U, mx, my, 8, upred[m]) + sse(V, mx, my, 8, vpred[m]);
        if (e < best_e) best = m, best_e = e;
      }
      mb.uvmode = best;
      for (int c = 0; c < 2; ++c) {
        Plane& S = c ? V : U;
        Plane& R = c ? RV : RU;
        const std::vector<int>& pp = c ? vpred[best] : upred[best];
        int (*levels)[16] = c ? mb.v : mb.u;
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) src[y * 8 + x] = S.at(8 * my + y, 8 * mx + x);
        for (int k = 0; k < 4; ++k) {
          const int off = (k >> 1) * 32 + (k & 1) * 4;
          int cf[16];
          ftransform(src + off, pp.data() + off, 8, cf);
          quantize(cf, muv, 0, levels[k], deq);
          for (int n = 0; n < 16; ++n) any |= levels[k][n] != 0;
          itransform(deq, pp.data() + off, 8, rec + off);
        }
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) R.at(8 * my + y, 8 * mx + x) = rec[y * 8 + x];
      }
      mb.skip = !any;
    }
  int n_skip = 0;
  for (const MB& mb : mbs) n_skip += mb.skip;
  const int total_mbs = mb_w * mb_h;
  const int skip_proba = (total_mbs - n_skip) * 255 / total_mbs;
  const bool use_skip = n_skip > 0 && skip_proba < 250;
  const int skip_p = skip_proba < 1 ? 1 : skip_proba;
  Tokens tk;
  std::vector<int> top_nz(2 * (size_t)mb_w, 0);
  for (int my = 0; my < mb_h; ++my) {
    int left_nz[2] = {0, 0};
    for (int mx = 0; mx < mb_w; ++mx) {
      const MB& mb = mbs[(size_t)my * mb_w + mx];
      int* top = &top_nz[2 * (size_t)mx];
      if (use_skip && mb.skip) {
        top[0] = left_nz[0] = top[1] = left_nz[1] = 0;
      } else {
        mb_tokens(tk, mb, top, left_nz);
      }
    }
  }
  // Probabilities: the default, or the token statistics' where it pays.
  std::vector<int64_t> ones(1056, 0), totals(1056, 0);
  for (const Token& t : tk.t)
    if (t.slot >= 0) ones[t.slot] += t.bit, totals[t.slot] += 1;
  std::vector<int> probs(1056);
  std::vector<bool> updated(1056, false);
  for (int i = 0; i < 1056; ++i) {
    probs[i] = (int)proba0[i];
    if (!totals[i]) continue;
    const int64_t nb = ones[i], tot = totals[i];
    int new_p = nb ? (int)(255 - nb * 255 / tot) : 255;
    if (new_p < 1) new_p = 1;
    const int old_p = (int)proba0[i], up = (int)update_proba[i];
    const int64_t old_cost = nb * bit_cost(cost, 1, old_p) + (tot - nb) * bit_cost(cost, 0, old_p) +
                             bit_cost(cost, 0, up);
    const int64_t new_cost = nb * bit_cost(cost, 1, new_p) + (tot - nb) * bit_cost(cost, 0, new_p) +
                             bit_cost(cost, 1, up) + 8 * 256;
    if (old_cost > new_cost) probs[i] = new_p, updated[i] = true;
  }
  // The first partition: the frame header and the modes.
  BoolWriter hdr;
  hdr.put(0, 0x80);  // colour space
  hdr.put(0, 0x80);  // clamping type
  hdr.put(0, 0x80);  // no segmentation
  hdr.put(0, 0x80);  // normal loop filter
  hdr.bits((int)level, 6);
  hdr.bits(0, 3);     // sharpness
  hdr.put(0, 0x80);   // no loop filter deltas
  hdr.bits(0, 2);     // one token partition
  hdr.bits((int)q, 7);
  const int deltas[5] = {0, 0, 0, (int)uv_dc, 0};  // y1 dc, y2 dc, y2 ac, uv dc, uv ac
  for (int d : deltas) {
    hdr.put(d != 0, 0x80);
    if (d) {
      hdr.bits(std::abs(d), 4);
      hdr.put(d < 0, 0x80);
    }
  }
  hdr.put(0, 0x80);  // refresh entropy probabilities
  for (int i = 0; i < 1056; ++i) {
    hdr.put(updated[i], (int)update_proba[i]);
    if (updated[i]) hdr.bits(probs[i], 8);
  }
  hdr.put(use_skip, 0x80);
  if (use_skip) hdr.bits(skip_p, 8);
  for (const MB& mb : mbs) {
    if (use_skip) hdr.put(mb.skip, skip_p);
    hdr.put(1, 145);  // 16x16 luma
    const int m = mb.ymode;  // 0 DC, 1 TM, 2 V, 3 H
    if (m == 1 || m == 3) {
      hdr.put(1, 156);
      hdr.put(m == 1, 128);
    } else {
      hdr.put(0, 156);
      hdr.put(m == 2, 163);
    }
    const int uv = mb.uvmode;
    hdr.put(uv != 0, 142);
    if (uv != 0) {
      hdr.put(uv != 2, 114);
      if (uv != 2) hdr.put(uv != 3, 183);
    }
  }
  hdr.finish();
  BoolWriter part;
  for (const Token& t : tk.t) part.put(t.bit, t.slot >= 0 ? probs[t.slot] : t.fixed);
  part.finish();
  const size_t size = 10 + hdr.out.size() + part.out.size();
  if ((int64_t)size > cap) return -1;
  const uint32_t tag = ((uint32_t)hdr.out.size() << 5) | (1u << 4);
  out[0] = (uint8_t)tag, out[1] = (uint8_t)(tag >> 8), out[2] = (uint8_t)(tag >> 16);
  out[3] = 0x9d, out[4] = 0x01, out[5] = 0x2a;
  out[6] = (uint8_t)w, out[7] = (uint8_t)(w >> 8), out[8] = (uint8_t)h, out[9] = (uint8_t)(h >> 8);
  std::memcpy(out + 10, hdr.out.data(), hdr.out.size());
  std::memcpy(out + 10 + hdr.out.size(), part.out.data(), part.out.size());
  return (int64_t)size;
}

}  // extern "C"
