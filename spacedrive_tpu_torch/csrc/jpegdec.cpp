// The port's JPEG decoder (media/jpeg.py is its plain numpy version).
//
// The JAX package opens images with PIL, which decodes JPEG through
// libjpeg-turbo; the machine with the card has neither, so the port decodes
// JPEG to libjpeg-turbo 3.1.3's samples itself, integer arithmetic only:
// the marker walk, Huffman decoding of sequential and progressive scans
// (spectral selection, successive approximation, EOB runs, restart
// intervals) into whole-image coefficient buffers, jpeg_idct_islow with the
// SIMD path's saturating outputs, fancy upsampling (h2v1, h2v2, h1v2) or
// replication, the YCbCr -> RGB tables of jdcolor.c, and four components
// as PIL reads CMYK (YCCK converted, every sample inverted). What it cannot
// give exactly it refuses with a status code; media/jpeg.py holds the
// reasons, and each refusal here is the plain version's refusal.
//
// One call decodes one file with the interpreter lock released (ctypes);
// sd_jpeg_header reads the frame header first so the caller can size the
// output and apply its pixel limit. Built by ops/_build.py with g++.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Must match media/jpeg.py.
enum Status {
  OK = 0,
  NOT_JPEG = 1,
  NO_EOI = 2,
  BAD_MARKER = 3,
  ARITHMETIC = 4,
  LOSSLESS = 5,
  HIERARCHICAL = 6,
  PRECISION = 7,
  COMPONENTS = 8,
  DNL = 9,
  BAD_TABLE = 10,
  BAD_FRAME = 11,
  BAD_SCAN = 12,
  SAMPLING = 13,
  CORRUPT_DATA = 14,
  PROGRESSION = 15,
  INCOMPLETE = 16,
  EXTREME_BLOCK = 17,
  SIZE = 18,
};

struct Refused {
  int code;
};

[[noreturn]] void refuse(int code) { throw Refused{code}; }

constexpr int MAX_DIMENSION = 65500;
constexpr int SMOOTHED_COEFS = 10;
constexpr int64_t IDCT_INPUT_MAX = 16383;

int NATURAL[64];

struct NaturalInit {
  NaturalInit() {
    int k = 0;
    for (int s = 0; s < 15; ++s) {
      int lo = s > 7 ? s - 7 : 0, hi = s < 7 ? s : 7;
      if (s % 2) {
        for (int r = lo; r <= hi; ++r) NATURAL[k++] = r * 8 + (s - r);
      } else {
        for (int r = hi; r >= lo; --r) NATURAL[k++] = r * 8 + (s - r);
      }
    }
  }
} natural_init;

struct Component {
  int cid, h, v, tq;
  bool has_qt = false;
  int64_t qt[64];
  int64_t bw, bh, bw_pad, bh_pad, dw, dh, offset;
  int scans = 0;
  int coef_bits[64];
};

struct Frame {
  bool progressive = false;
  int64_t width = 0, height = 0;
  int hmax = 1, vmax = 1;
  int64_t mcux = 0, mcuy = 0, blocks = 0;
  std::vector<Component> comps;
};

struct Huffman {
  bool defined = false;
  std::vector<uint16_t> lut;  // 16 bits at the read position -> len << 8 | symbol
};

inline uint16_t be16(const uint8_t* p) { return (uint16_t)(p[0] << 8 | p[1]); }

void read_frame(int marker, const uint8_t* p, int64_t len, Frame& f, int64_t max_pixels) {
  if (len < 6) refuse(BAD_FRAME);
  const int precision = p[0];
  f.height = be16(p + 1);
  f.width = be16(p + 3);
  const int n = p[5];
  if (precision != 8) refuse(PRECISION);
  if (f.height == 0) refuse(DNL);
  if (n != 1 && n != 3 && n != 4) refuse(COMPONENTS);
  if (f.width == 0 || f.width > MAX_DIMENSION || f.height > MAX_DIMENSION || len != 6 + 3 * n)
    refuse(BAD_FRAME);
  f.progressive = marker == 0xC2;
  f.comps.resize(n);
  for (int i = 0; i < n; ++i) {
    Component& c = f.comps[i];
    c.cid = p[6 + 3 * i];
    c.h = p[7 + 3 * i] >> 4;
    c.v = p[7 + 3 * i] & 15;
    c.tq = p[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) refuse(BAD_FRAME);
  }
  f.hmax = f.vmax = 1;
  for (auto& c : f.comps) {
    if (c.h > f.hmax) f.hmax = c.h;
    if (c.v > f.vmax) f.vmax = c.v;
  }
  f.mcux = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
  f.mcuy = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
  int64_t total = 0;
  int per_mcu = 0;
  for (auto& c : f.comps) {
    if (f.hmax % c.h || f.vmax % c.v) refuse(SAMPLING);
    c.dw = (f.width * c.h + f.hmax - 1) / f.hmax;
    c.dh = (f.height * c.v + f.vmax - 1) / f.vmax;
    c.bw = (c.dw + 7) / 8;
    c.bh = (c.dh + 7) / 8;
    c.bw_pad = f.mcux * c.h;
    c.bh_pad = f.mcuy * c.v;
    c.offset = total;
    total += c.bw_pad * c.bh_pad;
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    per_mcu += c.h * c.v;
  }
  if (n > 1 && per_mcu > 10) refuse(SAMPLING);
  f.blocks = total;
  if (f.width * f.height > max_pixels) refuse(SIZE);
}

void read_dht(const uint8_t* p, int64_t len, Huffman tables[2][4]) {
  int64_t pos = 0;
  while (pos < len) {
    if (pos + 17 > len) refuse(BAD_TABLE);
    const int tc_th = p[pos];
    const uint8_t* bits = p + pos + 1;
    int count = 0;
    for (int i = 0; i < 16; ++i) count += bits[i];
    if ((tc_th & 0xEC) || count > 256 || pos + 17 + count > len) refuse(BAD_TABLE);
    const uint8_t* values = p + pos + 17;
    if (!(tc_th >> 4))
      for (int i = 0; i < count; ++i)
        if (values[i] > 15) refuse(BAD_TABLE);
    Huffman& t = tables[tc_th >> 4][tc_th & 3];
    t.lut.assign(1 << 16, 0);
    int64_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; ++length) {
      for (int i = 0; i < bits[length - 1]; ++i) {
        if (code >= ((int64_t)1 << length)) refuse(BAD_TABLE);  // before writing past the table
        const int64_t span = (int64_t)1 << (16 - length);
        const uint16_t e = (uint16_t)(length << 8 | values[k]);
        for (int64_t j = code * span; j < (code + 1) * span; ++j) t.lut[j] = e;
        ++code;
        ++k;
      }
      if (code >= ((int64_t)1 << length)) refuse(BAD_TABLE);
      code <<= 1;
    }
    t.defined = true;
    pos += 17 + count;
  }
}

void read_dqt(const uint8_t* p, int64_t len, int64_t quant[4][64], bool defined[4]) {
  int64_t pos = 0;
  while (pos < len) {
    const int pq = p[pos] >> 4, tq = p[pos] & 15;
    if (pq > 1 || tq > 3) refuse(BAD_TABLE);
    const int64_t size = 64 * (1 + pq);
    if (pos + 1 + size > len) refuse(BAD_TABLE);
    for (int k = 0; k < 64; ++k)
      quant[tq][k] = pq ? be16(p + pos + 1 + 2 * k) : p[pos + 1 + k];
    defined[tq] = true;
    pos += 1 + size;
  }
}

// libjpeg's next_marker: skip non-FF bytes, FF fill and FF 00 pairs.
int next_marker(const uint8_t* d, int64_t n, int64_t& pos) {
  for (;;) {
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) refuse(NO_EOI);
    if (d[pos] != 0) return d[pos++];
    ++pos;
  }
}

// Segment payload [*p, *p + len) after a marker with a length field.
void segment(const uint8_t* d, int64_t n, int64_t& pos, const uint8_t*& p, int64_t& len) {
  if (pos + 2 > n) refuse(NO_EOI);
  const int64_t length = be16(d + pos);
  if (length < 2) refuse(BAD_MARKER);
  if (pos + length > n) refuse(NO_EOI);
  p = d + pos + 2;
  len = length - 2;
  pos += length;
}

// Unstuffed entropy bytes from pos to the next marker (FF 00 and FF FF..00
// are one FF byte); returns the marker and leaves pos after it.
int entropy_segment(const uint8_t* d, int64_t n, int64_t& pos, std::vector<uint8_t>& out) {
  out.clear();
  for (;;) {
    while (pos < n && d[pos] != 0xFF) out.push_back(d[pos++]);
    if (pos >= n) refuse(NO_EOI);
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) refuse(NO_EOI);
    if (d[pos] == 0) {
      out.push_back(0xFF);
      ++pos;
      continue;
    }
    return d[pos++];
  }
}

struct Bits {
  const uint8_t* buf;
  int64_t size;  // bytes
  int64_t pos = 0;  // bits

  uint32_t byte_at(int64_t i) const { return i < size ? buf[i] : 0u; }
  uint32_t peek16() const {
    const int64_t i = pos >> 3;
    const uint32_t w = byte_at(i) << 16 | byte_at(i + 1) << 8 | byte_at(i + 2);
    return (w >> (8 - (pos & 7))) & 0xFFFF;
  }
  uint32_t get(int s) {
    const int64_t i = pos >> 3;
    const uint32_t w = byte_at(i) << 24 | byte_at(i + 1) << 16 | byte_at(i + 2) << 8 |
                       byte_at(i + 3);
    const uint32_t v = s ? (w >> (32 - (pos & 7) - s)) & ((1u << s) - 1) : 0;
    pos += s;
    return v;
  }
  int huff(const Huffman& t) {
    const uint16_t e = t.lut[peek16()];
    if (!e) refuse(CORRUPT_DATA);
    pos += e >> 8;
    return e & 0xFF;
  }
  // Far past the segment (the plain version reads off its padding here).
  void guard() const {
    if (pos > 8 * size + 32) refuse(CORRUPT_DATA);
  }
};

inline int extend(uint32_t r, int s) {
  return r < (1u << (s - 1)) ? (int)r - (1 << s) + 1 : (int)r;
}

struct ScanComp {
  int ci, td, ta;
};

struct Decoder {
  Decoder(const uint8_t* data, int64_t size) : d(data), n(size) {}
  const uint8_t* d;
  int64_t n;
  Frame f;
  Huffman tables[2][4];
  int64_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  int restart = 0;
  std::vector<int16_t> coef;
  std::vector<uint8_t> seg;

  void decode_scan(int64_t& pos, int& marker, const std::vector<ScanComp>& sc, int ss, int se,
                   int ah, int al);
};

void Decoder::decode_scan(int64_t& pos, int& marker, const std::vector<ScanComp>& sc, int ss,
                          int se, int ah, int al) {
  // Blocks of the scan in order: per MCU, `per` flat block indices.
  std::vector<int64_t> blocks;
  std::vector<int> block_comp;
  int64_t n_mcu;
  int per;
  if (sc.size() == 1) {
    const Component& c = f.comps[sc[0].ci];
    for (int64_t by = 0; by < c.bh; ++by)
      for (int64_t bx = 0; bx < c.bw; ++bx) blocks.push_back(c.offset + by * c.bw_pad + bx);
    n_mcu = c.bh * c.bw;
    per = 1;
    block_comp.push_back(0);
  } else {
    per = 0;
    for (size_t k = 0; k < sc.size(); ++k) {
      const Component& c = f.comps[sc[k].ci];
      for (int i = 0; i < c.h * c.v; ++i) block_comp.push_back((int)k);
      per += c.h * c.v;
    }
    n_mcu = f.mcux * f.mcuy;
    blocks.reserve(n_mcu * per);
    for (int64_t my = 0; my < f.mcuy; ++my)
      for (int64_t mx = 0; mx < f.mcux; ++mx)
        for (const auto& s : sc) {
          const Component& c = f.comps[s.ci];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h)
              blocks.push_back(c.offset + (my * c.v + v) * c.bw_pad + mx * c.h + h);
        }
  }
  const bool need_dc = !f.progressive || (ss == 0 && ah == 0);
  const bool need_ac = !f.progressive || ss > 0;
  for (const auto& s : sc)
    if ((need_dc && !tables[0][s.td].defined) || (need_ac && !tables[1][s.ta].defined))
      refuse(BAD_TABLE);
  const int64_t interval = restart ? restart : n_mcu;
  int rst = 0;
  for (int64_t start = 0; start < n_mcu; start += interval) {
    marker = entropy_segment(d, n, pos, seg);
    Bits bits{seg.data(), (int64_t)seg.size()};
    int last[4] = {0, 0, 0, 0};
    int64_t eobrun = 0;
    const int64_t stop = start + interval < n_mcu ? start + interval : n_mcu;
    for (int64_t m = start; m < stop; ++m) {
      for (int j = 0; j < per; ++j) {
        const int k = block_comp[j];
        int16_t* row = &coef[blocks[m * per + j] * 64];
        const Huffman& dct = tables[0][sc[k].td];
        const Huffman& act = tables[1][sc[k].ta];
        if (!f.progressive) {
          const int s = bits.huff(dct);
          const int diff = s ? extend(bits.get(s), s) : 0;
          last[k] = (int)((uint32_t)last[k] + (uint32_t)diff);
          row[0] = (int16_t)last[k];
          for (int i = 1; i < 64; ++i) {
            const int rs = bits.huff(act);
            const int r = rs >> 4, sz = rs & 15;
            if (sz) {
              i += r;
              if (i > 63) refuse(CORRUPT_DATA);
              row[i] = (int16_t)extend(bits.get(sz), sz);
            } else if (r == 15) {
              i += 15;
            } else {
              break;
            }
          }
        } else if (ss == 0 && ah == 0) {
          const int s = bits.huff(dct);
          const int diff = s ? extend(bits.get(s), s) : 0;
          last[k] = (int)((uint32_t)last[k] + (uint32_t)diff);
          row[0] = (int16_t)(int32_t)((uint32_t)last[k] << al);
        } else if (ss == 0) {
          if (bits.get(1)) row[0] = (int16_t)(row[0] | (1 << al));
        } else if (ah == 0) {
          if (eobrun > 0) {
            --eobrun;
          } else {
            for (int i = ss; i <= se; ++i) {
              const int rs = bits.huff(act);
              const int r = rs >> 4, sz = rs & 15;
              if (sz) {
                i += r;
                if (i > se) refuse(CORRUPT_DATA);
                row[i] = (int16_t)(int32_t)((uint32_t)extend(bits.get(sz), sz) << al);
              } else if (r == 15) {
                i += 15;
              } else {
                eobrun = ((int64_t)1 << r) + (r ? bits.get(r) : 0) - 1;
                break;
              }
            }
          }
        } else {
          const int p1 = 1 << al, m1 = -1 * (1 << al);
          int i = ss;
          if (eobrun == 0) {
            for (; i <= se; ++i) {
              const int rs = bits.huff(act);
              int r = rs >> 4, s = rs & 15;
              if (s) {
                if (s != 1) refuse(CORRUPT_DATA);
                s = bits.get(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = ((int64_t)1 << r) + (r ? bits.get(r) : 0);
                break;
              }
              for (; i <= se; ++i) {
                const int c = row[i];
                if (c) {
                  if (bits.get(1) && !(c & p1)) row[i] = (int16_t)(c >= 0 ? c + p1 : c + m1);
                } else if (--r < 0) {
                  break;
                }
              }
              if (s) {
                if (i > se) refuse(CORRUPT_DATA);
                row[i] = (int16_t)s;
              }
            }
          }
          if (eobrun > 0) {
            for (; i <= se; ++i) {
              const int c = row[i];
              if (c && bits.get(1) && !(c & p1)) row[i] = (int16_t)(c >= 0 ? c + p1 : c + m1);
            }
            --eobrun;
          }
        }
        bits.guard();
      }
    }
    if (bits.pos > 8 * bits.size) refuse(CORRUPT_DATA);
    if (stop < n_mcu) {
      if (marker != 0xD0 + rst) refuse(CORRUPT_DATA);
      rst = (rst + 1) & 7;
    }
  }
}

void check_progression(Frame& f, const std::vector<ScanComp>& sc, int ss, int se, int ah,
                       int al) {
  bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || sc.size() != 1);
  if ((ah && al != ah - 1) || al > 13 || bad) refuse(PROGRESSION);
  for (const auto& s : sc) {
    int* bits = f.comps[s.ci].coef_bits;
    if (ss && bits[0] < 0) refuse(PROGRESSION);
    for (int k = ss; k <= se; ++k) {
      if (ah != (bits[k] > 0 ? bits[k] : 0) || (ah == 0 && bits[k] >= 0)) refuse(PROGRESSION);
      bits[k] = al;
    }
  }
}

int sof_refusal(int m) {
  switch (m) {
    case 0xC3: case 0xCB: return LOSSLESS;
    case 0xC9: case 0xCA: case 0xCC: return ARITHMETIC;
    case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF: return HIERARCHICAL;
    case 0xDC: return DNL;
    default: return OK;
  }
}

bool has_length(int m) {
  return m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC4 || m == 0xDA || m == 0xDB ||
         m == 0xDD || m == 0xFE || (m >= 0xE0 && m <= 0xEF);
}

// The walk; with header_only it stops at the frame header. Returns whether
// the components need no colour conversion: three that are RGB, four that
// are CMYK (not YCCK).
bool walk(Decoder& dec, bool header_only, int64_t max_pixels) {
  const uint8_t* d = dec.d;
  const int64_t n = dec.n;
  if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF) refuse(NOT_JPEG);
  int64_t pos = 2;
  bool have_frame = false, jfif = false, adobe = false, sequential_done = false;
  int transform = -1;
  int marker = next_marker(d, n, pos);
  for (;;) {
    if (marker == 0xD9) break;
    if (const int r = sof_refusal(marker)) refuse(r);
    if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) {
      marker = next_marker(d, n, pos);
      continue;
    }
    if (!has_length(marker)) refuse(BAD_MARKER);
    const uint8_t* p;
    int64_t len;
    segment(d, n, pos, p, len);
    if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
      if (have_frame) refuse(BAD_MARKER);
      read_frame(marker, p, len, dec.f, max_pixels);
      have_frame = true;
      if (header_only) return false;
      dec.coef.assign((size_t)(dec.f.blocks * 64), 0);
    } else if (marker == 0xC4) {
      read_dht(p, len, dec.tables);
    } else if (marker == 0xDB) {
      read_dqt(p, len, dec.quant, dec.quant_defined);
    } else if (marker == 0xDD) {
      if (len != 2) refuse(BAD_MARKER);
      dec.restart = be16(p);
    } else if (marker == 0xE0) {
      jfif = jfif || (len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0);
    } else if (marker == 0xEE) {
      if (len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
        adobe = true;
        transform = p[11];
      }
    } else if (marker == 0xDA) {
      if (!have_frame || sequential_done) refuse(BAD_MARKER);
      Frame& f = dec.f;
      if (len < 1) refuse(BAD_SCAN);
      const int ns = p[0];
      if (ns < 1 || ns > 4 || len != 4 + 2 * ns) refuse(BAD_SCAN);
      std::vector<ScanComp> sc;
      bool seen[4] = {false, false, false, false};
      int per_mcu = 0;
      for (int i = 0; i < ns; ++i) {
        const int cid = p[1 + 2 * i], t = p[2 + 2 * i];
        int match = -1;
        for (size_t k = 0; k < f.comps.size(); ++k)
          if (f.comps[k].cid == cid && !seen[k]) {
            match = (int)k;
            break;
          }
        if (match < 0 || (t >> 4) > 3 || (t & 15) > 3) refuse(BAD_SCAN);
        if (!sc.empty() && match < sc.back().ci) refuse(BAD_SCAN);
        seen[match] = true;
        sc.push_back({match, t >> 4, t & 15});
        per_mcu += f.comps[match].h * f.comps[match].v;
      }
      const int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
      const int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
      if (ns > 1 && per_mcu > 10) refuse(SAMPLING);
      if (f.progressive) {
        check_progression(f, sc, ss, se, ah, al);
      } else {
        if (ss != 0 || se != 63 || ah != 0 || al != 0) refuse(BAD_SCAN);
        bool first = true;
        for (const auto& c : f.comps) first = first && c.scans == 0;
        for (const auto& s : sc)
          if (f.comps[s.ci].scans) refuse(BAD_SCAN);
        sequential_done = first && sc.size() == f.comps.size();
      }
      for (const auto& s : sc) {
        Component& c = f.comps[s.ci];
        if (!c.has_qt) {
          if (!dec.quant_defined[c.tq]) refuse(BAD_TABLE);
          std::memcpy(c.qt, dec.quant[c.tq], sizeof(c.qt));
          c.has_qt = true;
        }
        ++c.scans;
      }
      dec.decode_scan(pos, marker, sc, ss, se, ah, al);
      continue;
    }
    marker = next_marker(d, n, pos);
  }
  if (!have_frame) refuse(BAD_MARKER);
  bool any = false;
  for (const auto& c : dec.f.comps) any = any || c.scans;
  if (!any) refuse(BAD_MARKER);
  if (dec.f.progressive)
    for (const auto& c : dec.f.comps)
      for (int k = 0; k < SMOOTHED_COEFS; ++k)
        if (c.coef_bits[k] != 0) refuse(INCOMPLETE);
  if (dec.f.comps.size() == 4) return !adobe || transform == 0;  // else YCCK
  if (dec.f.comps.size() != 3 || jfif) return false;
  if (adobe) return transform == 0;
  return dec.f.comps[0].cid == 82 && dec.f.comps[1].cid == 71 && dec.f.comps[2].cid == 66;
}

constexpr int CONST_BITS = 13, PASS1_BITS = 2;

// One islow butterfly: in[k * stride], k = 0..7 -> out[0..7] undescaled.
inline void idct_1d(const int64_t* in, int stride, int64_t out[8]) {
  const int64_t c0 = in[0], c1 = in[stride], c2 = in[2 * stride], c3 = in[3 * stride];
  const int64_t c4 = in[4 * stride], c5 = in[5 * stride], c6 = in[6 * stride],
                c7 = in[7 * stride];
  int64_t z1 = (c2 + c6) * 4433;
  const int64_t tmp2 = z1 - c6 * 15137;
  const int64_t tmp3 = z1 + c2 * 6270;
  const int64_t tmp0 = (c0 + c4) * (1 << CONST_BITS);
  const int64_t tmp1 = (c0 - c4) * (1 << CONST_BITS);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = c7, t1 = c5, t2 = c3, t3 = c1;
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const int64_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  out[0] = tmp10 + t3;
  out[7] = tmp10 - t3;
  out[1] = tmp11 + t2;
  out[6] = tmp11 - t2;
  out[2] = tmp12 + t1;
  out[5] = tmp12 - t1;
  out[3] = tmp13 + t0;
  out[4] = tmp13 - t0;
}

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

inline int64_t absl(int64_t x) { return x < 0 ? -x : x; }

// One block of zigzag coefficients -> 8x8 samples at out (row stride).
void idct_block(const int16_t* zz, const int64_t* qt, uint8_t* out, int64_t stride) {
  int64_t deq[64], ws[64], o[8];
  for (int k = 0; k < 64; ++k) {
    deq[NATURAL[k]] = (int64_t)zz[k] * qt[k];
    if (absl(deq[NATURAL[k]]) > IDCT_INPUT_MAX) refuse(EXTREME_BLOCK);
  }
  for (int col = 0; col < 8; ++col) {
    idct_1d(deq + col, 8, o);
    for (int k = 0; k < 8; ++k) {
      ws[k * 8 + col] = (int32_t)descale(o[k], CONST_BITS - PASS1_BITS);
      if (absl(ws[k * 8 + col]) > IDCT_INPUT_MAX) refuse(EXTREME_BLOCK);
    }
  }
  for (int row = 0; row < 8; ++row) {
    idct_1d(ws + row * 8, 1, o);
    for (int k = 0; k < 8; ++k) {
      const int64_t x = descale(o[k], CONST_BITS + PASS1_BITS + 3) + 128;
      out[row * stride + k] = (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
    }
  }
}

// A component's [dh, dw] samples (row stride `stride`) -> [dh*v, dw*h].
void upsample(const uint8_t* p, int64_t dh, int64_t dw, int64_t stride, int he, int ve,
              bool fancy, std::vector<uint8_t>& out) {
  const int64_t ow = dw * he, oh = dh * ve;
  out.assign((size_t)(ow * oh), 0);
  auto at = [&](int64_t y, int64_t x) -> int {
    y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
    x = x < 0 ? 0 : (x >= dw ? dw - 1 : x);
    return p[y * stride + x];
  };
  if (fancy && he == 2 && ve == 1) {
    for (int64_t y = 0; y < dh; ++y)
      for (int64_t x = 0; x < dw; ++x) {
        const int t = 3 * at(y, x);
        out[y * ow + 2 * x] = (uint8_t)((t + at(y, x - 1) + 1) >> 2);
        out[y * ow + 2 * x + 1] = (uint8_t)((t + at(y, x + 1) + 2) >> 2);
      }
  } else if (he == 1 && ve == 2) {
    for (int64_t y = 0; y < dh; ++y)
      for (int64_t x = 0; x < dw; ++x) {
        const int t = 3 * at(y, x);
        out[(2 * y) * ow + x] = (uint8_t)((t + at(y - 1, x) + 1) >> 2);
        out[(2 * y + 1) * ow + x] = (uint8_t)((t + at(y + 1, x) + 2) >> 2);
      }
  } else if (fancy && he == 2 && ve == 2) {
    std::vector<int> cols((size_t)dw);
    for (int64_t oy = 0; oy < oh; ++oy) {
      const int64_t y = oy >> 1;
      const int64_t far = (oy & 1) ? y + 1 : y - 1;
      for (int64_t x = 0; x < dw; ++x) cols[x] = 3 * at(y, x) + at(far, x);
      for (int64_t x = 0; x < dw; ++x) {
        const int t = 3 * cols[x];
        const int prev = cols[x > 0 ? x - 1 : 0], next = cols[x + 1 < dw ? x + 1 : dw - 1];
        out[oy * ow + 2 * x] = (uint8_t)((t + prev + 8) >> 4);
        out[oy * ow + 2 * x + 1] = (uint8_t)((t + next + 7) >> 4);
      }
    }
  } else {
    for (int64_t oy = 0; oy < oh; ++oy)
      for (int64_t ox = 0; ox < ow; ++ox) out[oy * ow + ox] = p[(oy / ve) * stride + ox / he];
  }
}

// `color`: -1 the markers decide, 0 convert (YCbCr or YCCK), 1 no
// conversion (libtiff's JCS_UNKNOWN for a TIFF whose photometric is RGB).
int decode(const uint8_t* data, int64_t n, int64_t max_pixels, int64_t color, uint8_t* out) {
  Decoder dec(data, n);
  const bool marked = walk(dec, false, max_pixels);
  const bool rgb = color < 0 ? marked : color == 1;
  const Frame& f = dec.f;
  const size_t nc = f.comps.size();
  std::vector<std::vector<uint8_t>> planes(nc);
  std::vector<int64_t> widths(nc);
  std::vector<uint8_t> samples, up;
  for (size_t ci = 0; ci < nc; ++ci) {
    const Component& c = f.comps[ci];
    const int64_t sw = c.bw_pad * 8;
    samples.assign((size_t)(c.bh_pad * 8 * sw), 0);
    static const int64_t zero_qt[64] = {0};
    const int64_t* qt = c.has_qt ? c.qt : zero_qt;
    for (int64_t by = 0; by < c.bh_pad; ++by)
      for (int64_t bx = 0; bx < c.bw_pad; ++bx)
        idct_block(&dec.coef[(c.offset + by * c.bw_pad + bx) * 64], qt,
                   &samples[by * 8 * sw + bx * 8], sw);
    const int he = f.hmax / c.h, ve = f.vmax / c.v;
    if (he == 1 && ve == 1) {
      planes[ci].swap(samples);
      widths[ci] = sw;
    } else {
      upsample(samples.data(), c.dh, c.dw, sw, he, ve, c.dw > 2, up);
      planes[ci].swap(up);
      widths[ci] = c.dw * he;
    }
  }
  const int64_t w = f.width, h = f.height;
  if (nc == 1) {
    for (int64_t y = 0; y < h; ++y) std::memcpy(out + y * w, &planes[0][y * widths[0]], w);
    return OK;
  }
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = (int)((91881 * x + 32768) >> 16);
    cb_b[i] = (int)((116130 * x + 32768) >> 16);
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + 32768;
  }
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  if (nc == 4) {
    // libjpeg's CMYK (YCCK: 255 - RGB, K as is), inverted as PIL reads it
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x) {
        const int a = planes[0][y * widths[0] + x], b = planes[1][y * widths[1] + x],
                  c = planes[2][y * widths[2] + x], k = planes[3][y * widths[3] + x];
        uint8_t* px = out + (y * w + x) * 4;
        if (rgb) {
          px[0] = (uint8_t)(255 - a);
          px[1] = (uint8_t)(255 - b);
          px[2] = (uint8_t)(255 - c);
        } else {
          px[0] = clamp(a + cr_r[c]);
          px[1] = clamp(a + (int)((cb_g[b] + cr_g[c]) >> 16));
          px[2] = clamp(a + cb_b[b]);
        }
        px[3] = (uint8_t)(255 - k);
      }
    return OK;
  }
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      const int a = planes[0][y * widths[0] + x], b = planes[1][y * widths[1] + x],
                c = planes[2][y * widths[2] + x];
      uint8_t* px = out + (y * w + x) * 3;
      if (rgb) {
        px[0] = (uint8_t)a;
        px[1] = (uint8_t)b;
        px[2] = (uint8_t)c;
      } else {
        px[0] = clamp(a + cr_r[c]);
        px[1] = clamp(a + (int)((cb_g[b] + cr_g[c]) >> 16));
        px[2] = clamp(a + cb_b[b]);
      }
    }
  return OK;
}

}  // namespace

extern "C" {

// Frame header: dims = {width, height, components}. Returns a status.
int64_t sd_jpeg_header(const uint8_t* data, int64_t n, int64_t max_pixels, int64_t* dims) {
  try {
    Decoder dec(data, n);
    walk(dec, true, max_pixels);
    dims[0] = dec.f.width;
    dims[1] = dec.f.height;
    dims[2] = (int64_t)dec.f.comps.size();
    return OK;
  } catch (const Refused& r) {
    return r.code;
  }
}

// The whole decode into out [height, width, components] uint8 (sized from
// sd_jpeg_header), the colour transform as `color` says (see decode).
// Returns a status.
int64_t sd_jpeg_decode(const uint8_t* data, int64_t n, int64_t max_pixels, int64_t color,
                       uint8_t* out) {
  try {
    return decode(data, n, max_pixels, color, out);
  } catch (const Refused& r) {
    return r.code;
  }
}

}  // extern "C"
