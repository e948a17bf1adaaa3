// The p2p tunnel's native primitives: X25519 (RFC 7748), the Ed25519 point
// arithmetic (RFC 8032: [s]B and the check [S]B - [k]A == R) and
// ChaCha20-Poly1305 (RFC 8439). SHA-512, HKDF and the scalar arithmetic mod
// L stay in Python (p2p/_crypto.py), which holds every function here
// against its plain twin.
//
// Field elements of GF(2^255 - 19) are five 51-bit limbs (the "donna-c64"
// form, products in unsigned __int128). Secret-dependent choices in the
// ladders are masked selects, not branches. Poly1305 is the 44/44/42-bit
// limb form. Plain C interface for ctypes; built by g++ (ops/_build.py).

#include <cstdint>
#include <cstring>

typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;
typedef unsigned __int128 u128;

namespace {

const u64 MASK51 = (1ULL << 51) - 1;

struct fe {
  u64 v[5];
};

u64 load64(const u8 *p) {
  u64 x;
  memcpy(&x, p, 8);  // little-endian hosts only (x86-64, aarch64)
  return x;
}

void fe_frombytes(fe &h, const u8 *s) {
  u64 t0 = load64(s), t1 = load64(s + 8), t2 = load64(s + 16), t3 = load64(s + 24);
  h.v[0] = t0 & MASK51;
  h.v[1] = ((t0 >> 51) | (t1 << 13)) & MASK51;
  h.v[2] = ((t1 >> 38) | (t2 << 26)) & MASK51;
  h.v[3] = ((t2 >> 25) | (t3 << 39)) & MASK51;
  h.v[4] = (t3 >> 12) & MASK51;  // bit 255 dropped
}

// Weak reduction: limbs 0..3 below 2^51, limb 4 at most a little past it.
void fe_carry(fe &h) {
  for (int i = 0; i < 4; i++) {
    h.v[i + 1] += h.v[i] >> 51;
    h.v[i] &= MASK51;
  }
  h.v[0] += 19 * (h.v[4] >> 51);
  h.v[4] &= MASK51;
  for (int i = 0; i < 4; i++) {
    h.v[i + 1] += h.v[i] >> 51;
    h.v[i] &= MASK51;
  }
}

void fe_tobytes(u8 *s, const fe &f) {
  fe t = f;
  fe_carry(t);
  fe_carry(t);
  // t < 2^255 + small; subtract p once where t >= p
  u64 q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  for (int i = 0; i < 4; i++) {
    t.v[i + 1] += t.v[i] >> 51;
    t.v[i] &= MASK51;
  }
  t.v[4] &= MASK51;
  u64 o0 = t.v[0] | (t.v[1] << 51);
  u64 o1 = (t.v[1] >> 13) | (t.v[2] << 38);
  u64 o2 = (t.v[2] >> 26) | (t.v[3] << 25);
  u64 o3 = (t.v[3] >> 39) | (t.v[4] << 12);
  memcpy(s, &o0, 8);
  memcpy(s + 8, &o1, 8);
  memcpy(s + 16, &o2, 8);
  memcpy(s + 24, &o3, 8);
}

void fe_add(fe &h, const fe &f, const fe &g) {
  for (int i = 0; i < 5; i++) h.v[i] = f.v[i] + g.v[i];
  fe_carry(h);
}

void fe_sub(fe &h, const fe &f, const fe &g) {
  // f + 4p - g, limbs of 4p: 4(2^51 - 19), then 4(2^51 - 1)
  h.v[0] = f.v[0] + 0x1FFFFFFFFFFFB4ULL - g.v[0];
  for (int i = 1; i < 5; i++) h.v[i] = f.v[i] + 0x1FFFFFFFFFFFFCULL - g.v[i];
  fe_carry(h);
}

void fe_mul(fe &h, const fe &f, const fe &g) {
  u64 f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
  u64 g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3], g4 = g.v[4];
  u64 g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;
  u128 t0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 + (u128)f3 * g2_19 +
            (u128)f4 * g1_19;
  u128 t1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 + (u128)f3 * g3_19 +
            (u128)f4 * g2_19;
  u128 t2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 + (u128)f3 * g4_19 +
            (u128)f4 * g3_19;
  u128 t3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 + (u128)f3 * g0 +
            (u128)f4 * g4_19;
  u128 t4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 + (u128)f3 * g1 +
            (u128)f4 * g0;
  t1 += (u64)(t0 >> 51);
  t2 += (u64)(t1 >> 51);
  t3 += (u64)(t2 >> 51);
  t4 += (u64)(t3 >> 51);
  u64 r0 = (u64)t0 & MASK51, r1 = (u64)t1 & MASK51, r2 = (u64)t2 & MASK51;
  u64 r3 = (u64)t3 & MASK51, r4 = (u64)t4 & MASK51;
  r0 += 19 * (u64)(t4 >> 51);
  r1 += r0 >> 51;
  r0 &= MASK51;
  h.v[0] = r0;
  h.v[1] = r1;
  h.v[2] = r2;
  h.v[3] = r3;
  h.v[4] = r4;
}

void fe_mul_small(fe &h, const fe &f, u64 c) {
  u128 carry = 0;
  for (int i = 0; i < 5; i++) {
    u128 t = (u128)f.v[i] * c + carry;
    h.v[i] = (u64)t & MASK51;
    carry = t >> 51;
  }
  h.v[0] += 19 * (u64)carry;
  h.v[1] += h.v[0] >> 51;
  h.v[0] &= MASK51;
}

// h = f^e, e as 32 little-endian bytes (public exponents only).
void fe_pow(fe &h, const fe &f, const u8 *e) {
  fe r = {{1, 0, 0, 0, 0}};
  for (int i = 255; i >= 0; i--) {
    fe_mul(r, r, r);
    if ((e[i >> 3] >> (i & 7)) & 1) fe_mul(r, r, f);
  }
  h = r;
}

// exponents p - 2 and (p + 3) / 8 = 2^252 - 2
const u8 EXP_INV[32] = {0xeb, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                        0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                        0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f};
const u8 EXP_SQRT[32] = {0xfe, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x0f};

void fe_invert(fe &h, const fe &f) { fe_pow(h, f, EXP_INV); }

void fe_cswap(fe &f, fe &g, u64 b) {
  u64 mask = (u64)0 - b;
  for (int i = 0; i < 5; i++) {
    u64 x = mask & (f.v[i] ^ g.v[i]);
    f.v[i] ^= x;
    g.v[i] ^= x;
  }
}

bool fe_equal(const fe &f, const fe &g) {
  u8 a[32], b[32];
  fe_tobytes(a, f);
  fe_tobytes(b, g);
  return memcmp(a, b, 32) == 0;
}

bool fe_isnegative(const fe &f) {
  u8 s[32];
  fe_tobytes(s, f);
  return s[0] & 1;
}

void fe_neg(fe &h, const fe &f) {
  fe zero = {{0, 0, 0, 0, 0}};
  fe_sub(h, zero, f);
}

// -- X25519 ------------------------------------------------------------------

void x25519(u8 *out, const u8 *scalar, const u8 *point) {
  u8 e[32];
  memcpy(e, scalar, 32);
  e[0] &= 248;
  e[31] &= 127;
  e[31] |= 64;
  fe x1, x2 = {{1, 0, 0, 0, 0}}, z2 = {{0, 0, 0, 0, 0}}, x3, z3 = {{1, 0, 0, 0, 0}};
  fe_frombytes(x1, point);
  x3 = x1;
  u64 swap = 0;
  for (int t = 254; t >= 0; t--) {
    u64 kt = (e[t >> 3] >> (t & 7)) & 1;
    swap ^= kt;
    fe_cswap(x2, x3, swap);
    fe_cswap(z2, z3, swap);
    swap = kt;
    fe a, aa, b, bb, e_, c, d, da, cb, tmp;
    fe_add(a, x2, z2);
    fe_mul(aa, a, a);
    fe_sub(b, x2, z2);
    fe_mul(bb, b, b);
    fe_sub(e_, aa, bb);
    fe_add(c, x3, z3);
    fe_sub(d, x3, z3);
    fe_mul(da, d, a);
    fe_mul(cb, c, b);
    fe_add(tmp, da, cb);
    fe_mul(x3, tmp, tmp);
    fe_sub(tmp, da, cb);
    fe_mul(tmp, tmp, tmp);
    fe_mul(z3, x1, tmp);
    fe_mul(x2, aa, bb);
    fe_mul_small(tmp, e_, 121665);
    fe_add(tmp, aa, tmp);
    fe_mul(z2, e_, tmp);
  }
  fe_cswap(x2, x3, swap);
  fe_cswap(z2, z3, swap);
  fe_invert(z2, z2);
  fe_mul(x2, x2, z2);
  fe_tobytes(out, x2);
}

// -- Ed25519 points (extended coordinates, a = -1) ----------------------------

struct ge {
  fe x, y, z, t;
};

const u8 D2_BYTES[32] = {89,  241, 178, 38,  148, 155, 214, 235, 86,  177, 131,
                         130, 154, 20,  224, 0,   48,  209, 243, 238, 242, 128,
                         142, 25,  231, 252, 223, 86,  220, 217, 6,   36};
const u8 D_BYTES[32] = {163, 120, 89,  19,  202, 77,  235, 117, 171, 216, 65,
                        65,  77,  10,  112, 0,   152, 232, 121, 119, 121, 64,
                        199, 140, 115, 254, 111, 43,  238, 108, 3,   82};
const u8 SQRTM1_BYTES[32] = {176, 160, 14,  74,  39,  27,  238, 196, 120, 228, 47,
                             173, 6,   24,  67,  47,  167, 215, 251, 61,  153, 0,
                             77,  43,  11,  223, 193, 79,  128, 36,  131, 43};
const u8 BX_BYTES[32] = {26,  213, 37,  143, 96,  45,  86,  201, 178, 167, 37,
                         149, 96,  199, 44,  105, 92,  220, 214, 253, 49,  226,
                         164, 192, 254, 83,  110, 205, 211, 54,  105, 33};
const u8 BY_BYTES[32] = {88,  102, 102, 102, 102, 102, 102, 102, 102, 102, 102,
                         102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102,
                         102, 102, 102, 102, 102, 102, 102, 102, 102, 102};

void ge_identity(ge &p) {
  p.x = {{0, 0, 0, 0, 0}};
  p.y = {{1, 0, 0, 0, 0}};
  p.z = {{1, 0, 0, 0, 0}};
  p.t = {{0, 0, 0, 0, 0}};
}

void ge_base(ge &p) {
  fe_frombytes(p.x, BX_BYTES);
  fe_frombytes(p.y, BY_BYTES);
  p.z = {{1, 0, 0, 0, 0}};
  fe_mul(p.t, p.x, p.y);
}

// RFC 8032 §5.1.4: complete, so it doubles too.
void ge_add(ge &r, const ge &p, const ge &q) {
  fe d2, a, b, c, d, e, f, g, h, t;
  fe_frombytes(d2, D2_BYTES);
  fe_sub(a, p.y, p.x);
  fe_sub(t, q.y, q.x);
  fe_mul(a, a, t);
  fe_add(b, p.y, p.x);
  fe_add(t, q.y, q.x);
  fe_mul(b, b, t);
  fe_mul(c, p.t, q.t);
  fe_mul(c, c, d2);
  fe_mul(d, p.z, q.z);
  fe_add(d, d, d);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.x, e, f);
  fe_mul(r.y, g, h);
  fe_mul(r.t, e, h);
  fe_mul(r.z, f, g);
}

void ge_cmov(ge &p, const ge &q, u64 b) {
  u64 mask = (u64)0 - b;
  for (int i = 0; i < 5; i++) {
    p.x.v[i] ^= mask & (p.x.v[i] ^ q.x.v[i]);
    p.y.v[i] ^= mask & (p.y.v[i] ^ q.y.v[i]);
    p.z.v[i] ^= mask & (p.z.v[i] ^ q.z.v[i]);
    p.t.v[i] ^= mask & (p.t.v[i] ^ q.t.v[i]);
  }
}

// r = [s]p, s as 32 little-endian bytes; the same adds for every scalar.
void ge_scalarmult(ge &r, const u8 *s, const ge &p) {
  ge q, sum;
  ge_identity(q);
  for (int i = 255; i >= 0; i--) {
    ge_add(q, q, q);
    ge_add(sum, q, p);
    ge_cmov(q, sum, (s[i >> 3] >> (i & 7)) & 1);
  }
  r = q;
}

void ge_tobytes(u8 *s, const ge &p) {
  fe zi, x, y;
  fe_invert(zi, p.z);
  fe_mul(x, p.x, zi);
  fe_mul(y, p.y, zi);
  fe_tobytes(s, y);
  s[31] ^= (u8)(fe_isnegative(x) << 7);
}

// RFC 8032 §5.1.3; false for a non-canonical y or a y off the curve.
bool ge_frombytes(ge &p, const u8 *s) {
  // y must be below p = 2^255 - 19
  u8 y_bytes[32];
  memcpy(y_bytes, s, 32);
  int sign = y_bytes[31] >> 7;
  y_bytes[31] &= 0x7f;
  bool ge_p = y_bytes[31] == 0x7f && y_bytes[0] >= 0xed;
  for (int i = 1; i < 31 && ge_p; i++) ge_p = y_bytes[i] == 0xff;
  if (ge_p) return false;
  fe y, d, u, v, x2, x, one = {{1, 0, 0, 0, 0}}, chk;
  fe_frombytes(y, y_bytes);
  fe_frombytes(d, D_BYTES);
  fe_mul(u, y, y);
  fe_mul(v, u, d);
  fe_sub(u, u, one);  // y^2 - 1
  fe_add(v, v, one);  // d y^2 + 1
  fe_invert(v, v);
  fe_mul(x2, u, v);
  fe zero = {{0, 0, 0, 0, 0}};
  if (fe_equal(x2, zero)) {
    if (sign) return false;
    x = zero;
  } else {
    fe_pow(x, x2, EXP_SQRT);
    fe_mul(chk, x, x);
    if (!fe_equal(chk, x2)) {
      fe sqrtm1;
      fe_frombytes(sqrtm1, SQRTM1_BYTES);
      fe_mul(x, x, sqrtm1);
      fe_mul(chk, x, x);
      if (!fe_equal(chk, x2)) return false;
    }
    if ((int)fe_isnegative(x) != sign) fe_neg(x, x);
  }
  p.x = x;
  p.y = y;
  p.z = one;
  fe_mul(p.t, x, y);
  return true;
}

// -- ChaCha20 and Poly1305 ----------------------------------------------------

inline u32 rotl(u32 v, int n) { return (v << n) | (v >> (32 - n)); }

#define QR(a, b, c, d)              \
  a += b, d = rotl(d ^ a, 16);      \
  c += d, b = rotl(b ^ c, 12);      \
  a += b, d = rotl(d ^ a, 8);       \
  c += d, b = rotl(b ^ c, 7)

void chacha20_block(u8 *out, const u8 *key, const u8 *nonce, u32 counter) {
  u32 s[16], x[16];
  s[0] = 0x61707865;
  s[1] = 0x3320646e;
  s[2] = 0x79622d32;
  s[3] = 0x6b206574;
  memcpy(s + 4, key, 32);
  s[12] = counter;
  memcpy(s + 13, nonce, 12);
  memcpy(x, s, 64);
  for (int i = 0; i < 10; i++) {
    QR(x[0], x[4], x[8], x[12]);
    QR(x[1], x[5], x[9], x[13]);
    QR(x[2], x[6], x[10], x[14]);
    QR(x[3], x[7], x[11], x[15]);
    QR(x[0], x[5], x[10], x[15]);
    QR(x[1], x[6], x[11], x[12]);
    QR(x[2], x[7], x[8], x[13]);
    QR(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; i++) x[i] += s[i];
  memcpy(out, x, 64);
}

void chacha20_xor(u8 *out, const u8 *in, u64 n, const u8 *key, const u8 *nonce,
                  u32 counter) {
  u8 block[64];
  for (u64 off = 0; off < n; off += 64, counter++) {
    chacha20_block(block, key, nonce, counter);
    u64 m = n - off < 64 ? n - off : 64;
    for (u64 i = 0; i < m; i++) out[off + i] = in[off + i] ^ block[i];
  }
}

struct poly1305 {
  u64 r[3], h[3], pad[2];
};

void poly_init(poly1305 &st, const u8 *key) {
  u64 t0 = load64(key), t1 = load64(key + 8);
  st.r[0] = t0 & 0xffc0fffffffULL;
  st.r[1] = ((t0 >> 44) | (t1 << 20)) & 0xfffffc0ffffULL;
  st.r[2] = (t1 >> 24) & 0x00ffffffc0fULL;
  st.h[0] = st.h[1] = st.h[2] = 0;
  st.pad[0] = load64(key + 16);
  st.pad[1] = load64(key + 24);
}

// One 16-byte block; `hibit` is 1 << 40 for a full block (the 2^128 bit).
void poly_block(poly1305 &st, const u8 *m, u64 hibit) {
  const u64 M44 = 0xfffffffffffULL, M42 = 0x3ffffffffffULL;
  u64 r0 = st.r[0], r1 = st.r[1], r2 = st.r[2];
  u64 s1 = r1 * (5 << 2), s2 = r2 * (5 << 2);
  u64 t0 = load64(m), t1 = load64(m + 8);
  u64 h0 = st.h[0] + (t0 & M44);
  u64 h1 = st.h[1] + (((t0 >> 44) | (t1 << 20)) & M44);
  u64 h2 = st.h[2] + (((t1 >> 24)) & M42) + hibit;
  u128 d0 = (u128)h0 * r0 + (u128)h1 * s2 + (u128)h2 * s1;
  u128 d1 = (u128)h0 * r1 + (u128)h1 * r0 + (u128)h2 * s2;
  u128 d2 = (u128)h0 * r2 + (u128)h1 * r1 + (u128)h2 * r0;
  u64 c = (u64)(d0 >> 44);
  h0 = (u64)d0 & M44;
  d1 += c;
  c = (u64)(d1 >> 44);
  h1 = (u64)d1 & M44;
  d2 += c;
  c = (u64)(d2 >> 42);
  h2 = (u64)d2 & M42;
  h0 += c * 5;
  c = h0 >> 44;
  h0 &= M44;
  h1 += c;
  st.h[0] = h0;
  st.h[1] = h1;
  st.h[2] = h2;
}

void poly_update(poly1305 &st, const u8 *m, u64 n) {
  u64 full = n & ~(u64)15;
  for (u64 i = 0; i < full; i += 16) poly_block(st, m + i, 1ULL << 40);
  if (n > full) {  // a final partial block, padded with 1 then zeros
    u8 last[16] = {0};
    memcpy(last, m + full, n - full);
    last[n - full] = 1;
    poly_block(st, last, 0);
  }
}

// Each AEAD section is zero-padded to 16 bytes: a full block of the padded data.
void poly_update_padded(poly1305 &st, const u8 *m, u64 n) {
  u64 full = n & ~(u64)15;
  for (u64 i = 0; i < full; i += 16) poly_block(st, m + i, 1ULL << 40);
  if (n > full) {
    u8 last[16] = {0};
    memcpy(last, m + full, n - full);
    poly_block(st, last, 1ULL << 40);
  }
}

void poly_finish(poly1305 &st, u8 *tag) {
  const u64 M44 = 0xfffffffffffULL, M42 = 0x3ffffffffffULL;
  u64 h0 = st.h[0], h1 = st.h[1], h2 = st.h[2];
  u64 c = h1 >> 44;
  h1 &= M44;
  h2 += c;
  c = h2 >> 42;
  h2 &= M42;
  h0 += c * 5;
  c = h0 >> 44;
  h0 &= M44;
  h1 += c;
  c = h1 >> 44;
  h1 &= M44;
  h2 += c;
  c = h2 >> 42;
  h2 &= M42;
  h0 += c * 5;
  c = h0 >> 44;
  h0 &= M44;
  h1 += c;
  // g = h + 5 - 2^130; take g where h >= p
  u64 g0 = h0 + 5;
  c = g0 >> 44;
  g0 &= M44;
  u64 g1 = h1 + c;
  c = g1 >> 44;
  g1 &= M44;
  u64 g2 = h2 + c - (1ULL << 42);
  u64 mask = (g2 >> 63) - 1;  // all ones where g2 did not underflow
  h0 = (h0 & ~mask) | (g0 & mask);
  h1 = (h1 & ~mask) | (g1 & mask);
  h2 = (h2 & ~mask) | (g2 & mask);
  // h + pad mod 2^128
  u64 t0 = st.pad[0], t1 = st.pad[1];
  h0 += t0 & M44;
  c = h0 >> 44;
  h0 &= M44;
  h1 += (((t0 >> 44) | (t1 << 20)) & M44) + c;
  c = h1 >> 44;
  h1 &= M44;
  h2 += ((t1 >> 24) & M42) + c;
  h2 &= M42;
  u64 o0 = h0 | (h1 << 44);
  u64 o1 = (h1 >> 20) | (h2 << 24);
  memcpy(tag, &o0, 8);
  memcpy(tag + 8, &o1, 8);
}

void aead_tag(u8 *tag, const u8 *key, const u8 *nonce, const u8 *aad, u64 aad_len,
              const u8 *ct, u64 ct_len) {
  u8 block0[64];
  chacha20_block(block0, key, nonce, 0);
  poly1305 st;
  poly_init(st, block0);
  poly_update_padded(st, aad, aad_len);
  poly_update_padded(st, ct, ct_len);
  u8 lens[16];
  memcpy(lens, &aad_len, 8);
  memcpy(lens + 8, &ct_len, 8);
  poly_update(st, lens, 16);
  poly_finish(st, tag);
}

}  // namespace

extern "C" {

void sd_x25519(u8 *out, const u8 *scalar, const u8 *point) { x25519(out, scalar, point); }

// [s]B, encoded.
void sd_ed25519_base(u8 *out, const u8 *s) {
  ge b, r;
  ge_base(b);
  ge_scalarmult(r, s, b);
  ge_tobytes(out, r);
}

// 1 where [S]B - [k]A encodes to R, 0 where not, -1 where A does not decode.
int sd_ed25519_check(const u8 *s, const u8 *k, const u8 *a_enc, const u8 *r_enc) {
  ge a, b, sb, ka, sum;
  if (!ge_frombytes(a, a_enc)) return -1;
  fe_neg(a.x, a.x);
  fe_neg(a.t, a.t);
  ge_base(b);
  ge_scalarmult(sb, s, b);
  ge_scalarmult(ka, k, a);
  ge_add(sum, sb, ka);
  u8 enc[32];
  ge_tobytes(enc, sum);
  return memcmp(enc, r_enc, 32) == 0 ? 1 : 0;
}

// ciphertext (n bytes) then the 16-byte tag into `out`.
void sd_aead_seal(const u8 *key, const u8 *nonce, const u8 *aad, u64 aad_len,
                  const u8 *plain, u64 n, u8 *out) {
  chacha20_xor(out, plain, n, key, nonce, 1);
  aead_tag(out + n, key, nonce, aad, aad_len, out, n);
}

// 0 and the plaintext in `out`, or -1 where the tag does not authenticate.
int sd_aead_open(const u8 *key, const u8 *nonce, const u8 *aad, u64 aad_len,
                 const u8 *sealed, u64 sealed_len, u8 *out) {
  if (sealed_len < 16) return -1;
  u64 n = sealed_len - 16;
  u8 tag[16];
  aead_tag(tag, key, nonce, aad, aad_len, sealed, n);
  u8 diff = 0;
  for (int i = 0; i < 16; i++) diff |= tag[i] ^ sealed[n + i];
  if (diff) return -1;
  chacha20_xor(out, sealed, n, key, nonce, 1);
  return 0;
}

}  // extern "C"
