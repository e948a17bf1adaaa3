// The strips and tiles of a TIFF, as libtiff 4.7.1 decodes them for PIL:
// LZW (new style) or PackBits decoded into exactly each one's size, raw or
// inflated data taken as it is, then Predictor 2 (horizontal differencing
// of 8 or 16-bit samples in the file's byte order) undone, and each placed
// into the image, edge tiles cropped. The plain versions are
// media/tiff.py's chunks_plain and chunk_plain; the status codes are its
// REASONS' first three.
//
// Built by spacedrive_tpu_torch/ops/_build.py with g++ into a shared
// library with a plain C interface (ctypes); it reads no file.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status : int64_t { OK = 0, SHORT_DATA = 1, CORRUPT_LZW = 2, OLD_LZW = 3 };
enum Route : int64_t { RAW = 1, LZW = 5, DEFLATE = 8, PACKBITS = 32773 };

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kTableSize = 5119;  // libtiff CSIZE

// LZWDecode: MSB-first codes of 9 to 12 bits, the width growing once the
// next free entry reaches 2**width - 1, Clear resetting the table, EOI or
// a full output ending the strip. The strip must start with Clear.
int64_t lzw(const uint8_t* src, int64_t n, uint8_t* out, int64_t size) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return OLD_LZW;
  static thread_local uint16_t prefix[kTableSize];
  static thread_local uint8_t suffix[kTableSize], first[kTableSize];
  static thread_local uint16_t length[kTableSize];
  for (int c = 0; c < 256; ++c) {
    suffix[c] = first[c] = (uint8_t)c;
    length[c] = 1;
  }
  int width = 9, next = kFirst, prev = -1;
  bool cleared = false;
  int64_t filled = 0, pos = 0;
  uint64_t acc = 0;  // bits not yet used, the next one highest
  int have = 0;
  while (filled < size) {
    while (have < width && pos < n) {
      acc = acc << 8 | src[pos++];
      have += 8;
    }
    if (have < width) return SHORT_DATA;
    const int c = (int)((acc >> (have - width)) & ((1u << width) - 1));
    have -= width;
    if (c == kClear) {
      width = 9;
      next = kFirst;
      prev = -1;
      cleared = true;
      continue;
    }
    if (c == kEoi) return SHORT_DATA;
    if (!cleared) return CORRUPT_LZW;
    if (prev < 0) {
      if (c > kEoi) return CORRUPT_LZW;
      out[filled++] = (uint8_t)c;
      prev = c;
      continue;
    }
    uint8_t head;
    if (c < next) {
      head = first[c];
    } else if (c == next) {
      head = first[prev];
    } else {
      return CORRUPT_LZW;
    }
    // The string of c (or of prev and its first byte, c == next), written
    // back to front, cut at the output's end.
    const int len = c < next ? length[c] : length[prev] + 1;
    const int64_t end = filled + len;
    int64_t at = end - 1;
    int k = c;
    if (c == next) {
      if (at < size) out[at] = head;
      --at;
      k = prev;
    }
    if (end <= size) {
      for (; at >= filled; --at, k = prefix[k]) out[at] = suffix[k];
    } else {
      for (; at >= filled; --at, k = prefix[k])
        if (at < size) out[at] = suffix[k];
    }
    filled = end < size ? end : size;
    if (next >= kTableSize) return CORRUPT_LZW;
    prefix[next] = (uint16_t)prev;
    suffix[next] = head;
    first[next] = first[prev];
    length[next] = (uint16_t)(length[prev] + 1);  // at most kTableSize
    ++next;
    if (next >= (1 << width) - 1 && width < 12) ++width;
    prev = c;
  }
  return OK;
}

// PackBitsDecode: a run past the output is cut (a literal one before its
// bytes are read); data that ends before the output is full fails.
int64_t packbits(const uint8_t* src, int64_t n, uint8_t* out, int64_t size) {
  int64_t pos = 0, filled = 0;
  while (pos < n && filled < size) {
    const int c = src[pos++];
    if (c == 128) continue;
    if (c > 128) {
      if (pos >= n) break;
      int64_t run = 257 - c;
      if (run > size - filled) run = size - filled;
      std::memset(out + filled, src[pos++], (size_t)run);
      filled += run;
    } else {  // a literal run past the output is cut before its data is needed
      const int64_t take = c + 1 > size - filled ? size - filled : c + 1;
      if (pos + take > n) break;
      std::memcpy(out + filled, src + pos, (size_t)take);
      filled += take;
      pos += take;
    }
  }
  return filled < size ? SHORT_DATA : OK;
}

void undo_predictor(uint8_t* buf, int64_t rows, int64_t rowbytes, int64_t spp,
                    int64_t depth, bool big) {
  if (depth == 8) {
    for (int64_t y = 0; y < rows; ++y) {
      uint8_t* row = buf + y * rowbytes;
      for (int64_t i = spp; i < rowbytes; ++i) row[i] = (uint8_t)(row[i] + row[i - spp]);
    }
    return;
  }
  const int64_t per_row = rowbytes / 2;
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* row = buf + y * rowbytes;
    for (int64_t i = spp; i < per_row; ++i) {
      uint8_t* cur = row + 2 * i;
      const uint8_t* before = row + 2 * (i - spp);
      const uint16_t a = big ? (uint16_t)(cur[0] << 8 | cur[1]) : (uint16_t)(cur[1] << 8 | cur[0]);
      const uint16_t b = big ? (uint16_t)(before[0] << 8 | before[1])
                             : (uint16_t)(before[1] << 8 | before[0]);
      const uint16_t v = (uint16_t)(a + b);
      cur[big ? 0 : 1] = (uint8_t)(v >> 8);
      cur[big ? 1 : 0] = (uint8_t)v;
    }
  }
}

// One strip or tile: `src` (n bytes: raw, inflated, LZW or PackBits data
// by `route`) → out[rows * rowbytes], then the predictor undone over
// `spp` interleaved samples of `depth` bits. Returns a Status.
int64_t chunk(const uint8_t* src, int64_t n, int64_t route, int64_t rows, int64_t rowbytes,
              int64_t predictor, int64_t spp, int64_t depth, int64_t big, uint8_t* out) {
  const int64_t size = rows * rowbytes;
  int64_t status = OK;
  if (route == LZW) {
    status = lzw(src, n, out, size);
  } else if (route == PACKBITS) {
    status = packbits(src, n, out, size);
  } else if (n >= size) {
    std::memcpy(out, src, (size_t)size);
  } else {
    status = SHORT_DATA;
  }
  if (status == OK && predictor == 2) undo_predictor(out, rows, rowbytes, spp, depth, big != 0);
  return status;
}

}  // namespace

extern "C" {

// Every strip or tile of an image, plane by plane and row of tiles by row,
// decoded and placed into out[planes][h][image rowbytes], edge tiles
// cropped. On PIL's raw route (route 1) a strip or tile is the rows the
// image holds at its offset, its byte count unread; else counts[k] bytes
// (inflated already for Deflate) decode to the whole strip or tile.
// Returns the Status of the first that fails.
int64_t sd_tiff_chunks(const uint8_t* data, int64_t n, int64_t route, const int64_t* offsets,
                       const int64_t* counts, int64_t planes, int64_t down, int64_t across,
                       int64_t tw, int64_t tl, int64_t tiled, int64_t w, int64_t h,
                       int64_t per_plane, int64_t depth, int64_t predictor, int64_t big,
                       uint8_t* out) {
  const int64_t rowbytes = (tw * per_plane * depth + 7) / 8;
  const int64_t image_rowbytes = (w * per_plane * depth + 7) / 8;
  std::vector<uint8_t> block((size_t)(tl * rowbytes));
  int64_t k = 0;
  for (int64_t p = 0; p < planes; ++p)
    for (int64_t ty = 0; ty < down; ++ty)
      for (int64_t tx = 0; tx < across; ++tx, ++k) {
        const int64_t y0 = ty * tl, x0 = tx * tw;
        const int64_t rows = tl < h - y0 ? tl : h - y0;
        const uint8_t* src;
        if (route == RAW) {
          if (offsets[k] < 0 || offsets[k] > n || n - offsets[k] < rows * rowbytes)
            return SHORT_DATA;
          src = data + offsets[k];
        } else {
          if (offsets[k] < 0 || counts[k] < 0 || offsets[k] > n || n - offsets[k] < counts[k])
            return SHORT_DATA;
          const int64_t status =
              chunk(data + offsets[k], counts[k], route, tiled ? tl : rows, rowbytes,
                            predictor, per_plane, depth, big, block.data());
          if (status != OK) return status;
          src = block.data();
        }
        const int64_t xb0 = x0 * per_plane * depth / 8;
        const int64_t take = rowbytes < image_rowbytes - xb0 ? rowbytes : image_rowbytes - xb0;
        for (int64_t r = 0; r < rows; ++r)
          std::memcpy(out + (p * h + y0 + r) * image_rowbytes + xb0, src + r * rowbytes,
                      (size_t)take);
      }
  return OK;
}

}  // extern "C"
