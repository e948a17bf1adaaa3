// WebP's bitstreams as libwebp 1.6.0 decodes them for PIL's
// WebPAnimDecoder (MODE_RGBA): VP8L (lossless) to RGB or RGBA, the ALPH
// chunk checked and decoded as libwebp does, VP8 key frames (lossy) to RGB through
// libwebp's loop filters, fancy upsampling and fixed-point YUV to RGB.
// The plain version, with the same status codes, is media/webp.py; the
// container walk there is shared by both.
//
// Built by spacedrive_tpu_torch/ops/_build.py with g++ into a shared
// library with a plain C interface (ctypes); it reads no file.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Status : int64_t {
  OK = 0,
  LOSSLESS_HEADER = 4,
  LOSSLESS_TRANSFORM = 5,
  LOSSLESS_CODE = 6,
  LOSSLESS_DATA = 7,
  LOSSLESS_END = 8,
  LOSSY_HEADER = 9,
  LOSSY_PARTITIONS = 10,
  LOSSY_END = 11,
  ALPHA_HEADER = 12,
};

// The constant tables of media/webp_tables.py (libwebp 1.6.0's order).
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22,
    22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82,
    83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112,
    114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151,
    154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
    49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82,
    84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122,
    125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173,
    177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284};
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253,
    136, 254, 255, 228, 219, 128, 128, 128, 128, 128, 189, 129, 242, 255, 227, 213, 255,
    219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128, 1, 98, 248,
    255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128,
    128, 128, 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243,
    255, 128, 128, 128, 128, 128, 184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77,
    110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1, 101, 251, 255, 241, 255, 128, 128,
    128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128, 37, 116, 196, 243,
    228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171,
    128, 128, 128, 128, 128, 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135,
    243, 255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255, 194, 224, 128, 128, 128,
    128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 246, 1, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 198, 35,
    237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252,
    221, 1, 68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224,
    255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99,
    181, 242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232, 253, 214, 197, 242, 196, 255,
    255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170,
    187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109,
    178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255,
    128, 128, 128, 1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251,
    218, 190, 255, 255, 128, 128, 128, 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128,
    128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128, 1, 157, 247,
    255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128,
    128, 128, 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255,
    128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1,
    177, 255, 224, 255, 128, 128, 128, 128, 128, 253, 9, 248, 251, 207, 208, 255, 192, 128,
    128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128, 73, 17, 171, 221, 161,
    179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239,
    90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255,
    128, 128, 128, 1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255,
    196, 186, 128, 128, 128, 128, 128, 69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128, 223, 165, 249, 255, 213, 255, 128,
    128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128, 1, 16, 248,
    255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128,
    128, 149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240,
    128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 134, 252, 255, 255, 128, 128, 128,
    128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128, 55, 93, 255, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126,
    38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46, 138, 219, 151, 178, 240, 170,
    255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252,
    211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250,
    221, 255, 255, 128, 24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225,
    249, 219, 240, 255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128,
    128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128, 1, 81, 230, 252, 204,
    203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128, 20,
    95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128,
    128, 128, 128, 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255,
    211, 212, 255, 255, 128, 128, 128, 1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255,
    205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 244, 1, 255, 128,
    128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176,
    246, 255, 255, 255, 255, 255, 255, 255, 255, 255, 223, 241, 252, 255, 255, 255, 255,
    255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 244,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 254, 255,
    255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255, 234, 250, 241,
    250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255,
    255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255, 248, 254,
    249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255,
    255, 255, 255, 246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 252, 255, 255, 255, 255, 255, 255,
    255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 249,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255};
const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95, 175,
    69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152, 114, 26, 17,
    163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85, 144, 71, 10, 38, 171,
    213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12,
    9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80, 66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53,
    9, 178, 241, 141, 26, 8, 107, 74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160,
    51, 52, 31, 115, 128, 104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15,
    186, 23, 47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61, 39, 53,
    200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77, 39, 28, 85, 171,
    58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73, 107, 54, 32, 26, 51, 1, 81,
    43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51, 193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148,
    31, 172, 219, 228, 21, 18, 111, 112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1,
    196, 245, 209, 10, 25, 109, 88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67,
    45, 68, 1, 209, 100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197,
    171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82, 138,
    31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179, 63, 59, 90,
    180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175, 47, 15, 16, 183, 34,
    223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1, 54, 17,
    37, 65, 32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37,
    9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40,
    41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10,
    32, 134, 39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73, 75,
    32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85, 56, 21, 23,
    111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125, 98, 42, 88, 104,
    85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45, 75, 79, 123, 47, 51, 128, 81,
    171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49, 38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10,
    67, 138, 77, 110, 90, 47, 114, 115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10,
    85, 128, 101, 196, 26, 57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128,
    68, 1, 26, 102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70, 37, 43, 37,
    154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85, 75, 15, 9, 9, 64, 255,
    184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1, 56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40, 164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103,
    44, 131, 131, 123, 31, 6, 158, 86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131,
    240, 154, 14, 1, 209, 45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23,
    102, 213, 83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128, 190, 80, 35,
    99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32, 101, 75, 128, 139, 118,
    146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62, 71, 30, 17, 119, 118, 255, 17,
    18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142, 146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64, 32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19,
    12, 61, 195, 128, 48, 4, 24};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72,
    4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86,
    90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46, 84, 92,
    67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122,
    33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110, 48,
    115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};

// -- VP8L ---------------------------------------------------------------------

constexpr int kLiteralCodes = 256, kLengthCodes = 24, kDistanceCodes = 40;
constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
constexpr uint32_t kHashMul = 0x1e35a7bdu;

// VP8L's bit reader, least significant bit first; zeros past the data.
// eos() is libwebp's end-of-stream test: its 64-bit window may run dry
// before it trips.
struct LBits {
  const uint8_t* data;
  int64_t n, pos = 0, limit;
  LBits(const uint8_t* d, int64_t size) : data(d), n(size), limit(8 * std::max<int64_t>(size, 8)) {}
  uint64_t window() const {
    const int64_t at = pos >> 3;
    uint64_t v = 0;
    if (at + 8 <= n) {
      std::memcpy(&v, data + at, 8);
    } else {
      for (int i = 0; i < 8 && at + i < n; ++i) v |= (uint64_t)data[at + i] << (8 * i);
    }
    return v >> (pos & 7);
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = (uint32_t)(window() & ((1ull << k) - 1));
    pos += k;
    return v;
  }
  bool eos() const { return pos > limit; }
};

// A canonical prefix code as two-level tables: `table` holds the root
// (1 << root_bits entries, indexed by the next root_bits bits read least
// significant first), then one second table for each root entry whose
// codes are longer. An entry is symbol << 16 | length (bit 7 clear), or
// for a second table offset << 8 | 0x80 | its bits. One symbol alone is a
// code of length 0 (root_bits 0).
constexpr int kRootBits = 8;

struct Code {
  int root_bits = 0;
  std::vector<uint32_t> table;
};

// libwebp's BuildHuffmanTable: false on no symbol, an over-subscribed or
// an incomplete code.
bool build_code(const std::vector<int>& lengths, int alphabet, Code& code) {
  std::vector<std::pair<int, int>> used;
  for (int s = 0; s < alphabet; ++s)
    if (lengths[s]) used.emplace_back(lengths[s], s);
  if (used.empty()) return false;
  if (used.size() == 1) {
    code.root_bits = 0;
    code.table.assign(1, (uint32_t)used[0].second << 16);
    return true;
  }
  std::sort(used.begin(), used.end());
  int64_t kraft = 0;
  for (auto& u : used) kraft += (int64_t)1 << (15 - u.first);
  if (kraft != (int64_t)1 << 15) return false;
  const int root = std::min(used.back().first, kRootBits);
  code.root_bits = root;
  code.table.assign((size_t)1 << root, 0);
  // Canonical codes, reversed for a least-significant-first stream.
  std::vector<uint32_t> rev(used.size());
  uint32_t c = 0;
  int prev = used[0].first;
  for (size_t i = 0; i < used.size(); ++i) {
    const int len = used[i].first;
    c <<= (len - prev);
    prev = len;
    uint32_t r = 0;
    for (int b = 0; b < len; ++b) r |= ((c >> b) & 1) << (len - 1 - b);
    rev[i] = r;
    ++c;
  }
  // The longest code under each root entry sets its second table's size.
  std::vector<int> sub_bits((size_t)1 << root, 0);
  for (size_t i = 0; i < used.size(); ++i)
    if (used[i].first > root) {
      int& bits = sub_bits[rev[i] & ((1u << root) - 1)];
      bits = std::max(bits, used[i].first - root);
    }
  for (uint32_t idx = 0; idx < ((uint32_t)1 << root); ++idx)
    if (sub_bits[idx]) {
      code.table[idx] = (uint32_t)code.table.size() << 8 | 0x80 | (uint32_t)sub_bits[idx];
      code.table.resize(code.table.size() + ((size_t)1 << sub_bits[idx]), 0);
    }
  for (size_t i = 0; i < used.size(); ++i) {
    const int len = used[i].first;
    const uint32_t entry = (uint32_t)used[i].second << 16 | (uint32_t)len;
    if (len <= root) {
      for (uint32_t k = 0; k < (1u << (root - len)); ++k) code.table[rev[i] | (k << len)] = entry;
    } else {
      const uint32_t ptr = code.table[rev[i] & ((1u << root) - 1)];
      const int bits = (int)(ptr & 0x0f);
      const uint32_t rest = rev[i] >> root;
      for (uint32_t k = 0; k < (1u << (bits - (len - root))); ++k)
        code.table[(ptr >> 8) + (rest | (k << (len - root)))] = entry;
    }
  }
  return true;
}

inline int read_symbol(LBits& br, const Code& code) {
  const uint64_t w = br.window();
  uint32_t e = code.table[w & ((1u << code.root_bits) - 1)];
  if (e & 0x80) e = code.table[(e >> 8) + ((w >> code.root_bits) & ((1u << (e & 0x0f)) - 1))];
  br.pos += e & 0x0f;
  return (int)(e >> 16);
}

int read_code(LBits& br, int alphabet, Code& code) {
  std::vector<int> lengths(std::max(alphabet, 256), 0);
  if (br.read(1)) {
    const int num = (int)br.read(1) + 1;
    const int first = (int)br.read(br.read(1) ? 8 : 1);
    lengths[first] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
  } else {
    const int num_codes = (int)br.read(4) + 4;
    std::vector<int> cl(19, 0);
    for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = (int)br.read(3);
    Code cl_code;
    if (!build_code(cl, 19, cl_code)) return LOSSLESS_CODE;
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(nbits);
      if (max_symbol > alphabet) return LOSSLESS_CODE;
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int c = read_symbol(br, cl_code);
      if (c < 16) {
        lengths[symbol++] = c;
        if (c) prev = c;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int repeat = (int)br.read(kExtra[c - 16]) + kOffset[c - 16];
        if (symbol + repeat > alphabet) return LOSSLESS_CODE;
        const int value = c == 16 ? prev : 0;
        for (int k = 0; k < repeat; ++k) lengths[symbol++] = value;
      }
    }
  }
  if (br.eos()) return LOSSLESS_END;
  if (!build_code(lengths, alphabet, code)) return LOSSLESS_CODE;
  return OK;
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int prefix_value(LBits& br, int symbol) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  return ((2 + (symbol & 1)) << extra) + (int)br.read(extra) + 1;
}

inline int plane_distance(int width, int code) {
  if (code > 120) return code - 120;
  const int d = kCodeToPlane[code - 1];
  const int dist = (d >> 4) * width + 8 - (d & 0xf);
  return dist >= 1 ? dist : 1;
}

struct Transform {
  int kind, width, bits;
  std::vector<uint32_t> data;  // the sub-image, or the expanded palette
  int data_width;
};

using Group = std::array<Code, 5>;

struct Lossless {
  LBits& br;
  bool alpha;

  // DecodeImageStream: transforms (level 0 only), colour cache, codes,
  // pixels; out is [ysize][width'] with width' the packed width.
  int image_stream(int xsize, int ysize, bool level0, std::vector<Transform>& transforms,
                   std::vector<uint32_t>& out, int& out_width) {
    int width = xsize;
    if (level0) {
      unsigned seen = 0;
      while (br.read(1)) {
        const int kind = (int)br.read(2);
        if (seen & (1u << kind)) return LOSSLESS_TRANSFORM;
        seen |= 1u << kind;
        Transform t{kind, width, 0, {}, 0};
        if (kind == 0 || kind == 1) {
          t.bits = (int)br.read(3) + 2;
          std::vector<Transform> none;
          const int st = image_stream(subsample(width, t.bits), subsample(ysize, t.bits), false,
                                      none, t.data, t.data_width);
          if (st) return st;
        } else if (kind == 3) {
          const int num = (int)br.read(8) + 1;
          t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
          std::vector<Transform> none;
          std::vector<uint32_t> pal;
          int pal_width;
          const int st = image_stream(num, 1, false, none, pal, pal_width);
          if (st) return st;
          const int size = 1 << (8 >> t.bits);
          t.data.assign(size, 0);
          uint8_t acc[4] = {0, 0, 0, 0};
          for (int i = 0; i < num && i < size; ++i) {
            uint32_t v = 0;
            for (int k = 0; k < 4; ++k) {
              acc[k] = (uint8_t)(acc[k] + ((pal[i] >> (8 * k)) & 0xff));
              v |= (uint32_t)acc[k] << (8 * k);
            }
            t.data[i] = v;
          }
          width = subsample(width, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > 11) return LOSSLESS_HEADER;
    }
    std::vector<Group> groups;
    int group_bits = 0, group_width = 0;
    std::vector<uint32_t> group_map;
    int st = codes(width, ysize, cache_bits, level0, groups, group_bits, group_map, group_width);
    if (st) return st;
    bool eight_bit = level0 && alpha && transforms.size() == 1 && transforms[0].kind == 3 &&
                     !cache_bits;
    for (auto& g : groups)
      for (int k = 1; k <= 3; ++k) eight_bit = eight_bit && g[k].root_bits == 0;
    out_width = width;
    return pixels(width, ysize, groups, group_bits, group_map, group_width, cache_bits, eight_bit,
                  out);
  }

  int codes(int xsize, int ysize, int cache_bits, bool allow_meta, std::vector<Group>& groups,
            int& group_bits, std::vector<uint32_t>& group_map, int& group_width) {
    int num_groups = 1;
    if (allow_meta && br.read(1)) {
      group_bits = (int)br.read(3) + 2;
      std::vector<Transform> none;
      const int st = image_stream(subsample(xsize, group_bits), subsample(ysize, group_bits),
                                  false, none, group_map, group_width);
      if (st) return st;
      for (auto& v : group_map) {
        v = (v >> 8) & 0xffff;
        num_groups = std::max(num_groups, (int)v + 1);
      }
    }
    if (br.eos()) return LOSSLESS_END;
    const int alphabets[5] = {kLiteralCodes + kLengthCodes + (cache_bits ? 1 << cache_bits : 0),
                              256, 256, 256, kDistanceCodes};
    groups.resize(num_groups);
    for (int g = 0; g < num_groups; ++g)
      for (int k = 0; k < 5; ++k) {
        const int st = read_code(br, alphabets[k], groups[g][k]);
        if (st) return st;
      }
    return OK;
  }

  int pixels(int width, int height, const std::vector<Group>& groups, int group_bits,
             const std::vector<uint32_t>& group_map, int group_width, int cache_bits,
             bool eight_bit, std::vector<uint32_t>& out) {
    const int64_t total = (int64_t)width * height;
    out.assign((size_t)total, 0);
    std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
    const int shift = 32 - cache_bits;
    int64_t cached = 0, pos = 0;
    int x = 0, y = 0;  // the position of pos
    const Group* group = &groups[0];
    while (pos < total) {
      if (br.pos > br.limit) return LOSSLESS_END;
      while (x >= width) {
        x -= width;
        ++y;
      }
      if (!group_map.empty())
        group = &groups[group_map[(size_t)(y >> group_bits) * group_width + (x >> group_bits)]];
      const int code = read_symbol(br, (*group)[0]);
      if (code < kLiteralCodes) {
        ++x;
        if (eight_bit) {
          out[pos++] = (uint32_t)code << 8;
          continue;
        }
        const uint32_t red = (uint32_t)read_symbol(br, (*group)[1]);
        const uint32_t blue = (uint32_t)read_symbol(br, (*group)[2]);
        const uint32_t alpha_v = (uint32_t)read_symbol(br, (*group)[3]);
        out[pos++] = alpha_v << 24 | red << 16 | (uint32_t)code << 8 | blue;
      } else if (code < kLiteralCodes + kLengthCodes) {
        const int length = prefix_value(br, code - kLiteralCodes);
        const int dist = plane_distance(width, prefix_value(br, read_symbol(br, (*group)[4])));
        if (br.pos > br.limit && !eight_bit) return LOSSLESS_END;
        if (pos < dist || total - pos < length) return LOSSLESS_DATA;
        for (int k = 0; k < length; ++k) out[pos + k] = out[pos + k - dist];
        pos += length;
        x += length;
      } else {
        if (!cache_bits) return LOSSLESS_DATA;
        while (cached < pos) {
          const uint32_t v = out[cached++];
          cache[(v * kHashMul) >> shift] = v;
        }
        out[pos++] = cache[code - kLiteralCodes - kLengthCodes];
        ++x;
      }
    }
    if (br.eos() && !eight_bit) return LOSSLESS_END;
    return OK;
  }
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int ch(uint32_t v, int k) { return (int)((v >> (8 * k)) & 0xff); }

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return avg2(avg2(L, TR), T);
    case 6: return avg2(L, TL);
    case 7: return avg2(L, T);
    case 8: return avg2(TL, T);
    case 9: return avg2(T, TR);
    case 10: return avg2(avg2(L, TL), avg2(T, TR));
    case 11: {
      int s = 0;
      for (int k = 0; k < 4; ++k) s += std::abs(ch(L, k) - ch(TL, k)) - std::abs(ch(T, k) - ch(TL, k));
      return s <= 0 ? T : L;
    }
    case 12: {
      uint32_t v = 0;
      for (int k = 0; k < 4; ++k) v |= (uint32_t)clip255(ch(L, k) + ch(T, k) - ch(TL, k)) << (8 * k);
      return v;
    }
    case 13: {
      const uint32_t a = avg2(L, T);
      uint32_t v = 0;
      for (int k = 0; k < 4; ++k) v |= (uint32_t)clip255(ch(a, k) + (ch(a, k) - ch(TL, k)) / 2) << (8 * k);
      return v;
    }
    default: return 0xff000000u;
  }
}

inline int signed8(uint32_t v) { return (int)(int8_t)(uint8_t)v; }

void inverse_transforms(const std::vector<Transform>& transforms, std::vector<uint32_t>& data,
                        int& width, int height) {
  for (auto it = transforms.rbegin(); it != transforms.rend(); ++it) {
    const Transform& t = *it;
    if (t.kind == 0) {
      const int w = width;
      std::vector<uint32_t> out(data.size());
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < w; ++x) {
          const size_t i = (size_t)y * w + x;
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : out[i - 1];
          } else if (x == 0) {
            pred = out[i - w];
          } else {
            const int mode = (t.data[(size_t)(y >> t.bits) * t.data_width + (x >> t.bits)] >> 8) & 0xf;
            pred = predict(mode, out[i - 1], out[i - w], out[i - w + 1], out[i - w - 1]);
          }
          out[i] = add_pixels(data[i], pred);
        }
      data.swap(out);
    } else if (t.kind == 1) {
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) {
          uint32_t& px = data[(size_t)y * width + x];
          const uint32_t m = t.data[(size_t)(y >> t.bits) * t.data_width + (x >> t.bits)];
          const int g2r = signed8(m), g2b = signed8(m >> 8), r2b = signed8(m >> 16);
          const int green = signed8(px >> 8);
          int red = (int)((px >> 16) & 0xff), blue = (int)(px & 0xff);
          red = (red + ((g2r * green) >> 5)) & 0xff;
          blue = (blue + ((g2b * green) >> 5) + ((r2b * signed8((uint32_t)red)) >> 5)) & 0xff;
          px = (px & 0xff00ff00u) | (uint32_t)red << 16 | (uint32_t)blue;
        }
    } else if (t.kind == 2) {
      for (auto& px : data) {
        const uint32_t g = (px >> 8) & 0xff;
        const uint32_t red = (((px >> 16) & 0xff) + g) & 0xff, blue = ((px & 0xff) + g) & 0xff;
        px = (px & 0xff00ff00u) | red << 16 | blue;
      }
    } else {
      const int w = t.width;
      std::vector<uint32_t> out((size_t)w * height);
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t index;
          if (t.bits) {
            const uint32_t packed = (data[(size_t)y * width + (x >> t.bits)] >> 8) & 0xff;
            const int per = 8 >> t.bits;
            index = (packed >> ((x & ((1 << t.bits) - 1)) * per)) & ((1u << per) - 1);
          } else {
            index = (data[(size_t)y * width + x] >> 8) & 0xff;
          }
          out[(size_t)y * w + x] = t.data[index];
        }
      data.swap(out);
      width = w;
    }
  }
}

// -- VP8 ----------------------------------------------------------------------

constexpr int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
                  kCat5[] = {180, 157, 141, 134, 130, 0},
                  kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
constexpr int DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE;
constexpr int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                      -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

// The VP8 boolean decoder (RFC 6386 section 7); zeros past its data, and
// `eof` as libwebp's reader sets it: on a read made once the bits shifted
// out pass 8 * (size - 1), and at once for an empty partition.
struct Bool {
  const uint8_t* data = nullptr;
  int64_t n = 0, pos = 2, shifts = 0, limit = 0;
  uint32_t value = 0, range = 255;
  int count = 0;
  bool eof = false;
  void init(const uint8_t* d, int64_t size) {
    data = d;
    n = size;
    value = (uint32_t)(byte(0) << 8 | byte(1));
    pos = 2;
    range = 255;
    count = 0;
    shifts = 0;
    limit = 8 * size - 8;
    eof = size == 0;
  }
  uint32_t byte(int64_t i) const { return i < n ? data[i] : 0; }
  int bit(int prob) {
    if (shifts > limit) eof = true;
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    const uint32_t big = split << 8;
    uint32_t rng;
    int b;
    if (value >= big) {
      rng = range - split;
      value -= big;
      b = 1;
    } else {
      rng = split;
      b = 0;
    }
    if (rng < 128) {
      int s = 0;
      while ((rng << s) < 128) ++s;
      rng <<= s;
      value <<= s;
      shifts += s;
      count += s;
      if (count >= 8) {
        count -= 8;
        value |= byte(pos++) << count;
      }
    }
    range = rng;
    return b;
  }
  int value_bits(int nbits) {
    int v = 0;
    while (nbits-- > 0) v = v << 1 | bit(0x80);
    return v;
  }
  int signed_bits(int nbits) {
    const int v = value_bits(nbits);
    return bit(0x80) ? -v : v;
  }
};

inline int16_t wrap16(int v) { return (int16_t)(uint16_t)(v & 0xffff); }

int large_value(Bool& br, const uint8_t* p) {
  if (!br.bit(p[3])) {
    if (!br.bit(p[4])) return 2;
    return 3 + br.bit(p[5]);
  }
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int bit0 = br.bit(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

using Probas = std::array<std::array<std::array<uint8_t, 11>, 3>, 8>;  // [band][ctx][node]

// GetCoeffs: one block's tokens from coefficient n into out (raster,
// 16-bit); returns the index past the last one read.
int get_coeffs(Bool& br, const Probas& prob, int ctx, const int dq[2], int n, int16_t* out) {
  const uint8_t* p = prob[kBands[n]][ctx].data();
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      if (++n == 16) return 16;
      p = prob[kBands[n]][0].data();
    }
    const auto& nxt = prob[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = nxt[1].data();
    } else {
      v = large_value(br, p);
      p = nxt[2].data();
    }
    if (br.bit(0x80)) v = -v;
    out[kZigzag[n]] = wrap16(v * dq[n > 0]);
  }
  return 16;
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne: the residual added to the prediction (before clipping).
void idct(const int16_t* in, int out[16]) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]), d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]), d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    out[4 * i + 0] = (a + d) >> 3;
    out[4 * i + 1] = (b + c) >> 3;
    out[4 * i + 2] = (b - c) >> 3;
    out[4 * i + 3] = (a - d) >> 3;
  }
}

// Transform_SSE2, which libwebp's x86-64 build runs for a block with more
// than three coefficients: TransformOne in 16-bit lanes that wrap, the
// multiplies as _mm_mulhi_epi16 by 20091 and by 35468 - 65536 plus the
// value itself. The caller adds the result to the prediction in 16 bits.
inline int w16(int v) { return (int16_t)(uint16_t)(v & 0xffff); }

void idct_sse2(const int16_t* in, int out[16]) {
  auto butterfly = [](int x0, int x1, int x2, int x3, int o[4]) {
    const int a = w16(x0 + x2), b = w16(x0 - x2);
    const int c = w16(w16(x1 - x3) + w16(((x1 * -30068) >> 16) - ((x3 * 20091) >> 16)));
    const int d = w16(w16(x1 + x3) + w16(((x1 * 20091) >> 16) + ((x3 * -30068) >> 16)));
    o[0] = w16(a + d);
    o[1] = w16(b + c);
    o[2] = w16(b - c);
    o[3] = w16(a - d);
  };
  int tmp[4][4];  // [pass-1 output][column]
  for (int j = 0; j < 4; ++j) {
    int o[4];
    butterfly(in[j], in[4 + j], in[8 + j], in[12 + j], o);
    for (int k = 0; k < 4; ++k) tmp[k][j] = o[k];
  }
  for (int i = 0; i < 4; ++i) {
    int o[4];
    butterfly(w16(tmp[i][0] + 4), tmp[i][1], tmp[i][2], tmp[i][3], o);
    for (int k = 0; k < 4; ++k) out[4 * i + k] = o[k] >> 3;
  }
}

void wht(const int16_t* in, int16_t* out /* 16 blocks, stride 16 */) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[3 + 4 * i], a1 = tmp[1 + 4 * i] + tmp[2 + 4 * i];
    const int a2 = tmp[1 + 4 * i] - tmp[2 + 4 * i], a3 = dc - tmp[3 + 4 * i];
    out[16 * (4 * i + 0)] = wrap16((a0 + a1) >> 3);
    out[16 * (4 * i + 1)] = wrap16((a3 + a2) >> 3);
    out[16 * (4 * i + 2)] = wrap16((a0 - a1) >> 3);
    out[16 * (4 * i + 3)] = wrap16((a3 - a2) >> 3);
  }
}

inline int clip(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2i(int a, int b) { return (a + b + 1) >> 1; }

// One 4x4 prediction (libwebp's VP8PredLuma4) in the work area `dst`
// (stride S): row -1 and column -1 hold the neighbours.
template <int S>
void predict4(int mode, uint8_t* dst) {
  auto D = [&](int x, int y) -> uint8_t& { return dst[x + y * S]; };
  const int A = dst[-S], B = dst[1 - S], C = dst[2 - S], Dd = dst[3 - S];
  const int E = dst[4 - S], F = dst[5 - S], G = dst[6 - S], H = dst[7 - S];
  const int I = dst[-1], J = dst[-1 + S], K = dst[-1 + 2 * S], L = dst[-1 + 3 * S];
  const int X = dst[-1 - S];
  switch (mode) {
    case B_DC: {
      const int dc = (A + B + C + Dd + I + J + K + L + 4) >> 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(x, y) = (uint8_t)dc;
      break;
    }
    case B_TM: {
      const int top[4] = {A, B, C, Dd}, left[4] = {I, J, K, L};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(x, y) = (uint8_t)clip(top[x] + left[y] - X);
      break;
    }
    case B_VE: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, Dd), avg3(C, Dd, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(x, y) = (uint8_t)v[x];
      break;
    }
    case B_HE: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(x, y) = (uint8_t)v[y];
      break;
    }
    case B_RD:
      D(0, 3) = (uint8_t)avg3(J, K, L);
      D(1, 3) = D(0, 2) = (uint8_t)avg3(I, J, K);
      D(2, 3) = D(1, 2) = D(0, 1) = (uint8_t)avg3(X, I, J);
      D(3, 3) = D(2, 2) = D(1, 1) = D(0, 0) = (uint8_t)avg3(A, X, I);
      D(3, 2) = D(2, 1) = D(1, 0) = (uint8_t)avg3(B, A, X);
      D(3, 1) = D(2, 0) = (uint8_t)avg3(C, B, A);
      D(3, 0) = (uint8_t)avg3(Dd, C, B);
      break;
    case B_LD: {
      const int v[7] = {avg3(A, B, C), avg3(B, C, Dd), avg3(C, Dd, E), avg3(Dd, E, F),
                        avg3(E, F, G), avg3(F, G, H), avg3(G, H, H)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(x, y) = (uint8_t)v[x + y];
      break;
    }
    case B_VR:
      D(0, 0) = D(1, 2) = (uint8_t)avg2i(X, A);
      D(1, 0) = D(2, 2) = (uint8_t)avg2i(A, B);
      D(2, 0) = D(3, 2) = (uint8_t)avg2i(B, C);
      D(3, 0) = (uint8_t)avg2i(C, Dd);
      D(0, 3) = (uint8_t)avg3(K, J, I);
      D(0, 2) = (uint8_t)avg3(J, I, X);
      D(0, 1) = D(1, 3) = (uint8_t)avg3(I, X, A);
      D(1, 1) = D(2, 3) = (uint8_t)avg3(X, A, B);
      D(2, 1) = D(3, 3) = (uint8_t)avg3(A, B, C);
      D(3, 1) = (uint8_t)avg3(B, C, Dd);
      break;
    case B_VL:
      D(0, 0) = (uint8_t)avg2i(A, B);
      D(1, 0) = D(0, 2) = (uint8_t)avg2i(B, C);
      D(2, 0) = D(1, 2) = (uint8_t)avg2i(C, Dd);
      D(3, 0) = D(2, 2) = (uint8_t)avg2i(Dd, E);
      D(0, 1) = (uint8_t)avg3(A, B, C);
      D(1, 1) = D(0, 3) = (uint8_t)avg3(B, C, Dd);
      D(2, 1) = D(1, 3) = (uint8_t)avg3(C, Dd, E);
      D(3, 1) = D(2, 3) = (uint8_t)avg3(Dd, E, F);
      D(3, 2) = (uint8_t)avg3(E, F, G);
      D(3, 3) = (uint8_t)avg3(F, G, H);
      break;
    case B_HU:
      D(0, 0) = (uint8_t)avg2i(I, J);
      D(2, 0) = D(0, 1) = (uint8_t)avg2i(J, K);
      D(2, 1) = D(0, 2) = (uint8_t)avg2i(K, L);
      D(1, 0) = (uint8_t)avg3(I, J, K);
      D(3, 0) = D(1, 1) = (uint8_t)avg3(J, K, L);
      D(3, 1) = D(1, 2) = (uint8_t)avg3(K, L, L);
      D(3, 2) = D(2, 2) = D(0, 3) = D(1, 3) = D(2, 3) = D(3, 3) = (uint8_t)L;
      break;
    default:  // B_HD
      D(0, 0) = D(2, 1) = (uint8_t)avg2i(I, X);
      D(0, 1) = D(2, 2) = (uint8_t)avg2i(J, I);
      D(0, 2) = D(2, 3) = (uint8_t)avg2i(K, J);
      D(0, 3) = (uint8_t)avg2i(L, K);
      D(3, 0) = (uint8_t)avg3(A, B, C);
      D(2, 0) = (uint8_t)avg3(X, A, B);
      D(1, 0) = D(3, 1) = (uint8_t)avg3(I, X, A);
      D(1, 1) = D(3, 2) = (uint8_t)avg3(J, I, X);
      D(1, 2) = D(3, 3) = (uint8_t)avg3(K, J, I);
      D(1, 3) = (uint8_t)avg3(L, K, J);
      break;
  }
}

struct Plane {
  int w, h;
  std::vector<uint8_t> px;
  uint8_t& at(int y, int x) { return px[(size_t)y * w + x]; }
};

// A 16x16 luma or 8x8 chroma prediction (DC with libwebp's edge
// variants, TM, V, H) into pred.
void predict_block(int mode, const int* top, const int* left, int tl, int size, bool has_top,
                   bool has_left, int* pred) {
  const int shift = size == 16 ? 4 : 3;
  if (mode == DC_PRED) {
    int st = 0, sl = 0;
    for (int i = 0; i < size; ++i) {
      st += top[i];
      sl += left[i];
    }
    int v;
    if (has_top && has_left) v = (st + sl + size) >> (shift + 1);
    else if (has_left) v = (sl + (size >> 1)) >> shift;
    else if (has_top) v = (st + (size >> 1)) >> shift;
    else v = 0x80;
    for (int i = 0; i < size * size; ++i) pred[i] = v;
    return;
  }
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x)
      pred[y * size + x] = mode == TM_PRED ? clip(top[x] + left[y] - tl)
                           : mode == V_PRED ? top[x] : left[y];
}

struct MB {
  int segment = 0, skip = 0, uv = 0;
  bool i4x4 = false;
  int modes[16];
};

struct FInfo {
  int limit, ilevel, hev;
  bool inner;
};

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// Filters across one edge at p (step between the taps, `lines` lines
// `stride` apart).
void simple_filter(uint8_t* p, int step, int stride, int lines, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < lines; ++i, p += stride) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t2) continue;
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = (uint8_t)clip(p0 + a2);
    p[0] = (uint8_t)clip(q0 - a1);
  }
}

void complex_filter(uint8_t* p, int step, int stride, int lines, int thresh, int ithresh,
                    int hev_thresh, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < lines; ++i, p += stride) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t2) continue;
    if (std::abs(p3 - p2) > ithresh || std::abs(p2 - p1) > ithresh ||
        std::abs(p1 - p0) > ithresh || std::abs(q3 - q2) > ithresh ||
        std::abs(q2 - q1) > ithresh || std::abs(q1 - q0) > ithresh)
      continue;
    if (std::abs(p1 - p0) > hev_thresh || std::abs(q1 - q0) > hev_thresh) {
      const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
      const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
      p[-step] = (uint8_t)clip(p0 + a2);
      p[0] = (uint8_t)clip(q0 - a1);
    } else if (edge) {
      const int w = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
      const int a1 = (27 * w + 63) >> 7, a2 = (18 * w + 63) >> 7, a3 = (9 * w + 63) >> 7;
      p[-3 * step] = (uint8_t)clip(p2 + a3);
      p[-2 * step] = (uint8_t)clip(p1 + a2);
      p[-step] = (uint8_t)clip(p0 + a1);
      p[0] = (uint8_t)clip(q0 - a1);
      p[step] = (uint8_t)clip(q1 - a2);
      p[2 * step] = (uint8_t)clip(q2 - a3);
    } else {
      const int a = 3 * (q0 - p0);
      const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
      p[-2 * step] = (uint8_t)clip(p1 + a3);
      p[-step] = (uint8_t)clip(p0 + a2);
      p[0] = (uint8_t)clip(q0 - a1);
      p[step] = (uint8_t)clip(q1 - a3);
    }
  }
}

struct Lossy {
  Lossy(const uint8_t* data, int64_t size, int w, int h) : buf(data), n(size), width(w), height(h) {}
  const uint8_t* buf;
  int64_t n;
  int width, height, mb_w = 0, mb_h = 0;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0}, seg_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0, filter_type = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  std::vector<Bool> parts;
  int dq[4][3][2];  // [segment][y1, y2, uv][dc, ac]
  Probas bands[4];
  int use_skip = 0, skip_p = 0;
  FInfo fstrengths[4][2];
  Plane Y, U, V;
  std::vector<FInfo> finfo;

  int decode(uint8_t* rgb) {
    if (n < 10) return LOSSY_HEADER;
    const uint32_t bits = buf[0] | buf[1] << 8 | buf[2] << 16;
    const int64_t part_len = bits >> 5;
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || buf[3] != 0x9d ||
        buf[4] != 0x01 || buf[5] != 0x2a)
      return LOSSY_HEADER;
    const int w = (buf[6] | buf[7] << 8) & 0x3fff, h = (buf[8] | buf[9] << 8) & 0x3fff;
    if (w != width || h != height || part_len > n - 10) return LOSSY_HEADER;
    Bool br;
    br.init(buf + 10, part_len);
    br.bit(0x80);  // colour space
    br.bit(0x80);  // clamping type
    if (!segment_header(br) || !filter_header(br)) return LOSSY_HEADER;
    if (!partitions(br, buf + 10 + part_len, n - 10 - part_len)) return LOSSY_PARTITIONS;
    quant(br);
    br.bit(0x80);  // refresh entropy probabilities: ignored
    proba(br);
    mb_w = (w + 15) >> 4;
    mb_h = (h + 15) >> 4;
    const int st = frame(br);
    if (st) return st;
    loop_filter();
    emit_rgb(rgb);
    return OK;
  }

  bool segment_header(Bool& br) {
    use_segment = br.bit(0x80);
    if (use_segment) {
      update_map = br.bit(0x80);
      if (br.bit(0x80)) {
        absolute_delta = br.bit(0x80);
        for (int s = 0; s < 4; ++s) seg_quant[s] = br.bit(0x80) ? br.signed_bits(7) : 0;
        for (int s = 0; s < 4; ++s) seg_filter[s] = br.bit(0x80) ? br.signed_bits(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) seg_probs[s] = br.bit(0x80) ? br.value_bits(8) : 255;
    }
    return !br.eof;
  }

  bool filter_header(Bool& br) {
    simple = br.bit(0x80);
    level = br.value_bits(6);
    sharpness = br.value_bits(3);
    use_lf_delta = br.bit(0x80);
    if (use_lf_delta && br.bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br.bit(0x80)) ref_lf_delta[i] = br.signed_bits(6);
      for (int i = 0; i < 4; ++i)
        if (br.bit(0x80)) mode_lf_delta[i] = br.signed_bits(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    return !br.eof;
  }

  bool partitions(Bool& br, const uint8_t* rest, int64_t size) {
    const int num = 1 << br.value_bits(2);
    const int64_t last = num - 1;
    if (size < 3 * last) return false;
    int64_t start = 3 * last, left = size - 3 * last;
    parts.assign(num, Bool());
    for (int64_t p = 0; p < last; ++p) {
      int64_t psize = rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16;
      if (psize > left) psize = left;
      parts[p].init(rest + start, psize);
      start += psize;
      left -= psize;
    }
    parts[last].init(rest + start, left);
    return start < size;
  }

  static int clipq(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

  void quant(Bool& br) {
    const int base = br.value_bits(7);
    int d[5];
    for (int i = 0; i < 5; ++i) d[i] = br.bit(0x80) ? br.signed_bits(4) : 0;
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment) {
        q = seg_quant[s] + (absolute_delta ? 0 : base);
      } else if (s > 0) {
        std::memcpy(dq[s], dq[0], sizeof(dq[0]));
        continue;
      } else {
        q = base;
      }
      dq[s][0][0] = kDcTable[clipq(q + d[0], 127)];
      dq[s][0][1] = kAcTable[clipq(q, 127)];
      dq[s][1][0] = kDcTable[clipq(q + d[1], 127)] * 2;
      dq[s][1][1] = std::max(8, (kAcTable[clipq(q + d[2], 127)] * 101581) >> 16);
      dq[s][2][0] = kDcTable[clipq(q + d[3], 117)];
      dq[s][2][1] = kAcTable[clipq(q + d[4], 127)];
    }
  }

  void proba(Bool& br) {
    for (int t = 0, i = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p, ++i)
            bands[t][b][c][p] =
                (uint8_t)(br.bit(kCoeffsUpdateProba[i]) ? br.value_bits(8) : kCoeffsProba0[i]);
    use_skip = br.bit(0x80);
    skip_p = use_skip ? br.value_bits(8) : 0;
  }

  void intra_row(Bool& br, std::vector<uint8_t>& top, std::vector<MB>& mbs) {
    uint8_t left[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MB& mb = mbs[mb_x];
      mb.segment = update_map ? (br.bit(seg_probs[0]) ? 2 + br.bit(seg_probs[2]) : br.bit(seg_probs[1]))
                              : 0;
      mb.skip = use_skip ? br.bit(skip_p) : 0;
      uint8_t* t = &top[4 * mb_x];
      mb.i4x4 = !br.bit(145);
      if (!mb.i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                      : (br.bit(163) ? V_PRED : DC_PRED);
        mb.modes[0] = ymode;
        for (int k = 0; k < 4; ++k) t[k] = left[k] = (uint8_t)ymode;
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = left[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba + (t[x] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
            ymode = -i;
            t[x] = (uint8_t)ymode;
          }
          for (int x = 0; x < 4; ++x) mb.modes[4 * y + x] = t[x];
          left[y] = (uint8_t)ymode;
        }
      }
      mb.uv = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
    }
  }

  // ParseResiduals; codes[24] gets each block's NzCodeBits (3 full, 2
  // three coefficients, 1 DC only, 0 none).
  void residuals(Bool& br, const MB& mb, uint8_t top[2], uint8_t left[2], int16_t* coeffs,
                 int* codes) {
    const int(*q)[2] = dq[mb.segment];
    std::memset(coeffs, 0, 384 * sizeof(int16_t));
    int first;
    const Probas* ac;
    if (!mb.i4x4) {
      int16_t dc[16] = {0};
      const int nz = get_coeffs(br, bands[1], top[1] + left[1], q[1], 0, dc);
      top[1] = left[1] = nz > 0;
      if (nz > 1) {
        wht(dc, coeffs);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16; ++i) coeffs[16 * i] = (int16_t)dc0;
      }
      first = 1;
      ac = &bands[0];
    } else {
      first = 0;
      ac = &bands[3];
    }
    uint8_t tnz = top[0] & 0x0f, lnz = left[0] & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 4; ++x) {
        int16_t* blk = coeffs + 16 * (4 * y + x);
        const int nz = get_coeffs(br, *ac, l + (tnz & 1), q[0], first, blk);
        l = nz > first;
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        codes[4 * y + x] = nz > 3 ? 3 : nz > 1 ? 2 : blk[0] != 0;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int c = 0; c < 4; c += 2) {
      tnz = (uint8_t)(top[0] >> (4 + c));
      lnz = (uint8_t)(left[0] >> (4 + c));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          int16_t* blk = coeffs + 16 * (16 + 2 * c + 2 * y + x);
          const int nz = get_coeffs(br, bands[2], l + (tnz & 1), q[2], 0, blk);
          l = nz > 0;
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          codes[16 + 2 * c + 2 * y + x] = nz > 3 ? 3 : nz > 1 ? 2 : blk[0] != 0;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      out_t |= (uint32_t)(tnz << 4) << c;
      out_l |= (uint32_t)(lnz & 0xf0) << c;
    }
    top[0] = (uint8_t)out_t;
    left[0] = (uint8_t)out_l;
  }

  void strengths() {
    for (int s = 0; s < 4; ++s) {
      const int base = use_segment ? seg_filter[s] + (absolute_delta ? 0 : level) : level;
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        int lv = base;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4x4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        FInfo& f = fstrengths[s][i4x4];
        f.inner = i4x4;
        if (lv > 0) {
          int il = lv;
          if (sharpness > 0) {
            il >>= sharpness > 4 ? 2 : 1;
            if (il > 9 - sharpness) il = 9 - sharpness;
          }
          if (il < 1) il = 1;
          f.ilevel = il;
          f.limit = 2 * lv + il;
          f.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          f.limit = f.ilevel = f.hev = 0;
        }
      }
    }
  }

  int frame(Bool& br0) {
    Y = Plane{16 * mb_w, 16 * mb_h, std::vector<uint8_t>((size_t)256 * mb_w * mb_h)};
    U = Plane{8 * mb_w, 8 * mb_h, std::vector<uint8_t>((size_t)64 * mb_w * mb_h)};
    V = Plane{8 * mb_w, 8 * mb_h, std::vector<uint8_t>((size_t)64 * mb_w * mb_h)};
    finfo.assign((size_t)mb_w * mb_h, FInfo{0, 0, 0, false});
    strengths();
    std::vector<uint8_t> intra_top(4 * mb_w, B_DC);
    std::vector<std::array<uint8_t, 2>> nz_top(mb_w, {0, 0});
    std::vector<MB> mbs(mb_w);
    std::vector<int16_t> coeffs(384);
    int codes[24];
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      intra_row(br0, intra_top, mbs);
      if (br0.eof) return LOSSY_END;
      Bool& tokens = parts[mb_y & (parts.size() - 1)];
      uint8_t nz_left[2] = {0, 0};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MB& mb = mbs[mb_x];
        bool skip = true;
        std::fill(codes, codes + 24, 0);
        if (!mb.skip) {
          residuals(tokens, mb, nz_top[mb_x].data(), nz_left, coeffs.data(), codes);
          for (int b = 0; b < 24; ++b) skip = skip && codes[b] == 0;
        } else {
          nz_top[mb_x][0] = nz_left[0] = 0;
          if (!mb.i4x4) nz_top[mb_x][1] = nz_left[1] = 0;
          std::fill(coeffs.begin(), coeffs.end(), 0);
        }
        if (tokens.eof) return LOSSY_END;
        if (filter_type) {
          FInfo f = fstrengths[mb.segment][mb.i4x4];
          f.inner = f.inner || !skip;
          finfo[(size_t)mb_y * mb_w + mb_x] = f;
        }
        reconstruct(mb_x, mb_y, mb, coeffs.data(), codes);
      }
    }
    return OK;
  }

  // The prediction from the unfiltered frame plus each block's residual:
  // libwebp's SSE2 transform (wrapping 16-bit add, then saturation) for a
  // luma block of code 3 and for all four blocks of a chroma plane with a
  // block of code 2 or 3, its C transforms for the rest.
  void reconstruct(int mb_x, int mb_y, const MB& mb, const int16_t* coeffs, const int* codes) {
    int res[24][16];
    bool sse2[24];
    for (int b = 0; b < 24; ++b) sse2[b] = b < 16 && codes[b] == 3;
    for (int first = 16; first < 24; first += 4) {
      const bool any = codes[first] >= 2 || codes[first + 1] >= 2 || codes[first + 2] >= 2 ||
                       codes[first + 3] >= 2;
      for (int b = first; b < first + 4; ++b) sse2[b] = any;
    }
    for (int b = 0; b < 24; ++b) {
      if (sse2[b]) idct_sse2(coeffs + 16 * b, res[b]);
      else if (codes[b]) idct(coeffs + 16 * b, res[b]);
      else std::fill(res[b], res[b] + 16, 0);  // no coefficient: no residual
    }
    auto add = [&](int pred, int b, int k) {
      return (uint8_t)clip(sse2[b] ? w16(pred + res[b][k]) : pred + res[b][k]);
    };
    const int y0 = 16 * mb_y, x0 = 16 * mb_x;
    int top[16], left[16];
    for (int i = 0; i < 16; ++i) {
      top[i] = mb_y ? Y.at(y0 - 1, x0 + i) : 127;
      left[i] = mb_x ? Y.at(y0 + i, x0 - 1) : 129;
    }
    const int tl = mb_y == 0 ? 127 : mb_x == 0 ? 129 : Y.at(y0 - 1, x0 - 1);
    if (!mb.i4x4) {
      int pred[256];
      predict_block(mb.modes[0], top, left, tl, 16, mb_y > 0, mb_x > 0, pred);
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x)
          Y.at(y0 + y, x0 + x) =
              add(pred[16 * y + x], 4 * (y >> 2) + (x >> 2), 4 * (y & 3) + (x & 3));
    } else {
      constexpr int S = 21;  // libwebp's work area: rows -1..15, columns -1..19
      uint8_t work[17 * S] = {0};
      uint8_t* w = work + S + 1;
      int top_right[4];
      for (int k = 0; k < 4; ++k)
        top_right[k] = mb_y == 0 ? 127 : mb_x == mb_w - 1 ? top[15] : Y.at(y0 - 1, x0 + 16 + k);
      w[-S - 1] = (uint8_t)tl;
      for (int i = 0; i < 16; ++i) {
        w[-S + i] = (uint8_t)top[i];
        w[i * S - 1] = (uint8_t)left[i];
      }
      for (int k = 0; k < 4; ++k)
        for (int r : {-1, 3, 7, 11}) w[r * S + 16 + k] = (uint8_t)top_right[k];
      for (int nb = 0; nb < 16; ++nb) {
        uint8_t* dst = w + 4 * (nb & 3) + 4 * (nb >> 2) * S;
        predict4<S>(mb.modes[nb], dst);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) dst[y * S + x] = add(dst[y * S + x], nb, 4 * y + x);
      }
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) Y.at(y0 + y, x0 + x) = w[y * S + x];
    }
    const int cy0 = 8 * mb_y, cx0 = 8 * mb_x;
    Plane* planes[2] = {&U, &V};
    for (int c = 0; c < 2; ++c) {
      Plane& P = *planes[c];
      int ctop[8], cleft[8], pred[64];
      for (int i = 0; i < 8; ++i) {
        ctop[i] = mb_y ? P.at(cy0 - 1, cx0 + i) : 127;
        cleft[i] = mb_x ? P.at(cy0 + i, cx0 - 1) : 129;
      }
      const int ctl = mb_y == 0 ? 127 : mb_x == 0 ? 129 : P.at(cy0 - 1, cx0 - 1);
      predict_block(mb.uv, ctop, cleft, ctl, 8, mb_y > 0, mb_x > 0, pred);
      const int first = 16 + 4 * c;
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x)
          P.at(cy0 + y, cx0 + x) =
              add(pred[8 * y + x], first + 2 * (y >> 2) + (x >> 2), 4 * (y & 3) + (x & 3));
    }
  }

  void loop_filter() {
    if (!filter_type) return;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
        if (f.limit == 0) continue;
        uint8_t* y = &Y.at(16 * mb_y, 16 * mb_x);
        const int ys = Y.w;
        if (filter_type == 1) {
          if (mb_x > 0) simple_filter(y, 1, ys, 16, f.limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_filter(y + k, 1, ys, 16, f.limit);
          if (mb_y > 0) simple_filter(y, ys, 1, 16, f.limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_filter(y + k * ys, ys, 1, 16, f.limit);
          continue;
        }
        uint8_t* u = &U.at(8 * mb_y, 8 * mb_x);
        uint8_t* v = &V.at(8 * mb_y, 8 * mb_x);
        const int cs = U.w;
        if (mb_x > 0) {
          complex_filter(y, 1, ys, 16, f.limit + 4, f.ilevel, f.hev, true);
          complex_filter(u, 1, cs, 8, f.limit + 4, f.ilevel, f.hev, true);
          complex_filter(v, 1, cs, 8, f.limit + 4, f.ilevel, f.hev, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) complex_filter(y + k, 1, ys, 16, f.limit, f.ilevel, f.hev, false);
          complex_filter(u + 4, 1, cs, 8, f.limit, f.ilevel, f.hev, false);
          complex_filter(v + 4, 1, cs, 8, f.limit, f.ilevel, f.hev, false);
        }
        if (mb_y > 0) {
          complex_filter(y, ys, 1, 16, f.limit + 4, f.ilevel, f.hev, true);
          complex_filter(u, cs, 1, 8, f.limit + 4, f.ilevel, f.hev, true);
          complex_filter(v, cs, 1, 8, f.limit + 4, f.ilevel, f.hev, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4)
            complex_filter(y + k * ys, ys, 1, 16, f.limit, f.ilevel, f.hev, false);
          complex_filter(u + 4 * cs, cs, 1, 8, f.limit, f.ilevel, f.hev, false);
          complex_filter(v + 4 * cs, cs, 1, 8, f.limit, f.ilevel, f.hev, false);
        }
      }
  }

  static int clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }

  // EmitFancyRGB: the chroma upsampled by libwebp's 9-3-3-1 filter (edges
  // replicated), then VP8YuvToRgb.
  void emit_rgb(uint8_t* rgb) {
    const int uw = (width + 1) >> 1, uh = (height + 1) >> 1;
    auto near_far = [](int i, int m, int& nr, int& fr) {
      nr = (i & 1) ? (i - 1) >> 1 : i >> 1;
      fr = (i & 1) ? (i + 1) >> 1 : (i >> 1) - 1;
      nr = std::min(std::max(nr, 0), m - 1);
      fr = std::min(std::max(fr, 0), m - 1);
    };
    std::vector<int> cn(width), cf(width);
    for (int x = 0; x < width; ++x) near_far(x, uw, cn[x], cf[x]);
    for (int y = 0; y < height; ++y) {
      int rn, rf;
      near_far(y, uh, rn, rf);
      for (int x = 0; x < width; ++x) {
        const int u = (9 * U.at(rn, cn[x]) + 3 * U.at(rn, cf[x]) + 3 * U.at(rf, cn[x]) +
                       U.at(rf, cf[x]) + 8) >> 4;
        const int v = (9 * V.at(rn, cn[x]) + 3 * V.at(rn, cf[x]) + 3 * V.at(rf, cn[x]) +
                       V.at(rf, cf[x]) + 8) >> 4;
        const int yy = (Y.at(y, x) * 19077) >> 8;
        uint8_t* o = rgb + 3 * ((size_t)y * width + x);
        o[0] = (uint8_t)clip8(yy + ((v * 26149) >> 8) - 14234);
        o[1] = (uint8_t)clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708);
        o[2] = (uint8_t)clip8(yy + ((u * 33050) >> 8) - 17685);
      }
    }
  }
};

}  // namespace

extern "C" {

// A VP8L chunk's payload (to the end of the frame's bytes) → out[h][w][c]:
// R, G, B, and with c = 4 the alpha the stream carries.
int64_t sd_webp_lossless_bands(const uint8_t* data, int64_t n, int64_t width, int64_t height,
                               int64_t c, uint8_t* out) {
  LBits br(data, n);
  if (br.read(8) != 0x2f) return LOSSLESS_HEADER;
  const int w = (int)br.read(14) + 1, h = (int)br.read(14) + 1;
  br.read(1);
  if (br.read(3) || w != width || h != height) return LOSSLESS_HEADER;
  Lossless dec{br, false};
  std::vector<Transform> transforms;
  std::vector<uint32_t> data_px;
  int packed_width;
  const int st = dec.image_stream(w, h, true, transforms, data_px, packed_width);
  if (st) return st;
  int out_width = packed_width;
  inverse_transforms(transforms, data_px, out_width, h);
  for (size_t i = 0; i < (size_t)w * h; ++i) {
    uint8_t* o = out + c * i;
    o[0] = (uint8_t)(data_px[i] >> 16);
    o[1] = (uint8_t)(data_px[i] >> 8);
    o[2] = (uint8_t)data_px[i];
    if (c == 4) o[3] = (uint8_t)(data_px[i] >> 24);
  }
  return OK;
}

// An ALPH chunk's payload for a width x height frame: OK, or why libwebp
// fails the frame on it; with `out` (else null) the plane itself
// [h][w], its rows unfiltered as libwebp's alpha decoder does (filters.c
// HorizontalUnfilter, VerticalUnfilter, GradientUnfilter).
int64_t sd_webp_alpha_plane(const uint8_t* data, int64_t n, int64_t width, int64_t height,
                            uint8_t* out) {
  if (n <= 1) return ALPHA_HEADER;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            rsrv = data[0] >> 6;
  if (method > 1 || pre > 1 || rsrv) return ALPHA_HEADER;
  const size_t total = (size_t)width * height;
  std::vector<uint8_t> raw;
  if (method == 0) {
    if ((size_t)(n - 1) < total) return ALPHA_HEADER;
    if (out == nullptr) return OK;
    raw.assign(data + 1, data + 1 + total);
  } else {
    LBits br(data + 1, n - 1);
    Lossless dec{br, true};
    std::vector<Transform> transforms;
    std::vector<uint32_t> px;
    int packed_width;
    const int st = dec.image_stream((int)width, (int)height, true, transforms, px,
                                    packed_width);
    if (st || out == nullptr) return st;
    int out_width = packed_width;
    inverse_transforms(transforms, px, out_width, (int)height);
    raw.resize(total);
    for (size_t i = 0; i < total; ++i) raw[i] = (uint8_t)(px[i] >> 8);
  }
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = &raw[(size_t)(y * width)];
    const uint8_t* prev = y ? out + (y - 1) * width : nullptr;
    uint8_t* row = out + y * width;
    if (filter == 0) {
      std::memcpy(row, in, (size_t)width);
    } else if (filter == 1 || prev == nullptr) {
      uint8_t pred = (filter == 1 && prev != nullptr) ? prev[0] : 0;
      for (int64_t i = 0; i < width; ++i) pred = row[i] = (uint8_t)(pred + in[i]);
    } else if (filter == 2) {
      for (int64_t i = 0; i < width; ++i) row[i] = (uint8_t)(prev[i] + in[i]);
    } else {
      int top = prev[0], top_left = top, left = top;
      for (int64_t i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        left = (uint8_t)(in[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        row[i] = (uint8_t)left;
      }
    }
  }
  return OK;
}

int64_t sd_webp_alpha(const uint8_t* data, int64_t n, int64_t width, int64_t height) {
  return sd_webp_alpha_plane(data, n, width, height, nullptr);
}

// A VP8 chunk's payload (to the end of the frame's bytes) → rgb[h][w][3].
int64_t sd_webp_lossy(const uint8_t* data, int64_t n, int64_t width, int64_t height,
                      uint8_t* rgb) {
  Lossy dec(data, n, (int)width, (int)height);
  return dec.decode(rgb);
}

}  // extern "C"
