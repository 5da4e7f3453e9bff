// Native modular ring arithmetic for the MPC secret-sharing domain.
//
// TPU-native framework runtime tier: the reference's hand-optimized Go
// big-int inner loops (hhcho/mpc-core RElem/RVec; used from mpc/mpc.go)
// become a C++ limb engine here.  Python keeps the canonical little-endian
// base-2^8 digit format of ops/ring.py (int32 [n, L]) at every protocol
// boundary -- PRG streams, wire format and share semantics are unchanged --
// and these kernels pack digits into 64-bit limbs, compute with
// unsigned __int128 multiplies, and unpack.
//
// Rings (id):
//   0  p256  = 2^256 - 189   (prime,  4 limbs, 32 digits)
//   1  p127  = 2^127 - 1     (prime,  2 limbs, 16 digits)
//   2  2^256                 (pow2,   4 limbs, 32 digits)
//   3  2^127                 (pow2,   2 limbs, 16 digits)
//
// All element loops release the GIL (ctypes) and parallelize with OpenMP.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef int64_t i64;
typedef int32_t i32;

namespace {

struct RingDef {
  int W;        // limbs
  int L;        // digits (W * 8)
  int prime;    // 1 = prime (2^bits - delta), 0 = power of two
  int bits;     // modulus bit count (prime: value bits; pow2: exponent)
  u64 delta;    // prime: 2^bits - p
};

static const RingDef RINGS[4] = {
    {4, 32, 1, 256, 189},  // p256
    {2, 16, 1, 127, 1},    // p127 (Mersenne)
    {4, 32, 0, 256, 0},    // 2^256
    {2, 16, 0, 127, 0},    // 2^127
};

// ---- limb helpers (W <= 4) ----

static inline void pack(const i32* d, int L, u64* v, int W) {
  for (int w = 0; w < W; ++w) {
    u64 x = 0;
    for (int j = 7; j >= 0; --j) x = (x << 8) | (u64)(uint8_t)d[w * 8 + j];
    v[w] = x;
  }
  (void)L;
}

static inline void unpack(const u64* v, int W, i32* d) {
  for (int w = 0; w < W; ++w) {
    u64 x = v[w];
    for (int j = 0; j < 8; ++j) {
      d[w * 8 + j] = (i32)(x & 0xff);
      x >>= 8;
    }
  }
}

// a += b over W limbs; returns carry bit
static inline u64 add_limbs(u64* a, const u64* b, int W) {
  u128 c = 0;
  for (int w = 0; w < W; ++w) {
    c += (u128)a[w] + b[w];
    a[w] = (u64)c;
    c >>= 64;
  }
  return (u64)c;
}

// a -= b over W limbs; returns borrow bit (1 if b > a)
static inline u64 sub_limbs(u64* a, const u64* b, int W) {
  unsigned char borrow = 0;
  for (int w = 0; w < W; ++w) {
    u64 bw = b[w];
    u64 t = a[w] - bw;
    u64 t2 = t - borrow;
    borrow = (a[w] < bw) | (t < (u64)borrow);
    a[w] = t2;
  }
  return borrow;
}

static inline int ge_limbs(const u64* a, const u64* b, int W) {
  for (int w = W - 1; w >= 0; --w) {
    if (a[w] > b[w]) return 1;
    if (a[w] < b[w]) return 0;
  }
  return 1;
}

struct RingOps {
  RingDef def;
  u64 p[4];  // modulus limbs (prime rings)

  explicit RingOps(const RingDef& d) : def(d) {
    for (int w = 0; w < 4; ++w) p[w] = 0;
    if (d.prime) {
      // p = 2^bits - delta
      if (d.bits == 256) {
        p[0] = (u64)(0 - d.delta);
        p[1] = p[2] = p[3] = ~(u64)0;
      } else {  // 127
        p[0] = (u64)(0 - d.delta);
        p[1] = (~(u64)0) >> 1;  // 2^63 - 1 (top limb of 2^127 - 1)
      }
    }
  }

  inline void mask_pow2(u64* v) const {
    if (def.bits == 127) v[1] &= (~(u64)0) >> 1;
    // bits == 256: nothing (exactly 4 limbs)
  }

  inline void canon(u64* v, u64 carry) const {
    // value = carry*2^(64W) + v; bring into [0, modulus)
    const int W = def.W;
    if (!def.prime) {
      mask_pow2(v);
      return;
    }
    if (def.bits == 256) {
      // 2^256 === delta: fold the carry (carry is 0/1 from adds)
      while (carry) {
        u128 c = (u128)carry * def.delta;
        carry = 0;
        for (int w = 0; w < W && c; ++w) {
          c += v[w];
          v[w] = (u64)c;
          c >>= 64;
        }
        carry = (u64)c;
      }
    } else {
      // p127: 2^128 === 2; carry*2^128 = 2*carry
      while (carry) {
        u128 c = (u128)carry * 2;
        carry = 0;
        for (int w = 0; w < W && c; ++w) {
          c += v[w];
          v[w] = (u64)c;
          c >>= 64;
        }
        carry = (u64)c;
      }
      // fold bit 127
      u64 top = v[1] >> 63;
      v[1] &= (~(u64)0) >> 1;
      u128 c = (u128)v[0] + top;
      v[0] = (u64)c;
      v[1] += (u64)(c >> 64);  // cannot overflow: v[1] < 2^63
    }
    while (ge_limbs(v, p, W)) sub_limbs(v, p, W);
  }

  inline void add(const u64* a, const u64* b, u64* o) const {
    const int W = def.W;
    for (int w = 0; w < W; ++w) o[w] = a[w];
    u64 carry = add_limbs(o, b, W);
    canon(o, carry);
  }

  inline void sub(const u64* a, const u64* b, u64* o) const {
    const int W = def.W;
    for (int w = 0; w < W; ++w) o[w] = a[w];
    u64 borrow = sub_limbs(o, b, W);
    if (borrow) {
      if (def.prime) {
        add_limbs(o, p, W);  // wraps the borrow away
      }  // pow2: two's-complement wrap is the ring semantics
    }
    if (!def.prime) mask_pow2(o);
  }

  inline void neg(const u64* a, u64* o) const {
    const int W = def.W;
    int zero = 1;
    for (int w = 0; w < W; ++w) zero &= (a[w] == 0);
    if (zero) {
      for (int w = 0; w < W; ++w) o[w] = 0;
      return;
    }
    if (def.prime) {
      for (int w = 0; w < W; ++w) o[w] = p[w];
      sub_limbs(o, a, W);
    } else {
      u64 zeros[4] = {0, 0, 0, 0};
      for (int w = 0; w < W; ++w) o[w] = zeros[w];
      sub_limbs(o, a, W);
      mask_pow2(o);
    }
  }

  // full product -> 2W limbs
  inline void mul_wide(const u64* a, const u64* b, u64* prod) const {
    const int W = def.W;
    for (int w = 0; w < 2 * W; ++w) prod[w] = 0;
    for (int i = 0; i < W; ++i) {
      u64 carry = 0;
      for (int j = 0; j < W; ++j) {
        u128 t = (u128)a[i] * b[j] + prod[i + j] + carry;
        prod[i + j] = (u64)t;
        carry = (u64)(t >> 64);
      }
      prod[i + W] = carry;
    }
  }

  // reduce a 2W-limb value into [0, modulus)
  inline void fold_wide(const u64* prod, u64* o) const {
    const int W = def.W;
    if (!def.prime) {
      for (int w = 0; w < W; ++w) o[w] = prod[w];
      mask_pow2(o);
      return;
    }
    if (def.bits == 256) {
      // v = lo + hi * 189  (2^256 === 189)
      u64 acc[5];
      u128 c = 0;
      for (int w = 0; w < W; ++w) {
        c += (u128)prod[w] + (u128)prod[w + W] * def.delta;
        acc[w] = (u64)c;
        c >>= 64;
      }
      acc[4] = (u64)c;  // <= delta
      u64 v[4] = {acc[0], acc[1], acc[2], acc[3]};
      canon(v, acc[4]);
      for (int w = 0; w < W; ++w) o[w] = v[w];
    } else {
      // p127: v (4 limbs, full 256 bits) -> fold at bit 127
      // v = lo127 + (v >> 127); the shifted part spans up to 129 bits, so
      // its own bit 128 (= bit 255 of v, weight 2^255 === 2 mod p) is
      // folded separately.
      u64 lo[2] = {prod[0], prod[1] & ((~(u64)0) >> 1)};
      u64 hi[2];
      hi[0] = (prod[1] >> 63) | (prod[2] << 1);
      hi[1] = (prod[2] >> 63) | (prod[3] << 1);
      u64 hi2 = prod[3] >> 63;  // bit 255
      u64 v[2] = {lo[0], lo[1]};
      u64 carry = add_limbs(v, hi, 2);
      u64 extra[2] = {2 * hi2, 0};
      carry += add_limbs(v, extra, 2);
      canon(v, carry);
      o[0] = v[0];
      o[1] = v[1];
    }
  }

  inline void mul(const u64* a, const u64* b, u64* o) const {
    u64 prod[8];
    mul_wide(a, b, prod);
    fold_wide(prod, o);
  }
};

static const RingOps OPS[4] = {RingOps(RINGS[0]), RingOps(RINGS[1]),
                               RingOps(RINGS[2]), RingOps(RINGS[3])};

// Generic signed-digit reduce: literal port of ops/ring.py np_reduce so the
// two paths are bit-identical.  d: int64 digits [nd], any sign; out int32 [L].
static void reduce_digits(const RingOps& R, const i64* din, int nd, i32* out) {
  const int L = R.def.L;
  i64 d[128];
  int n = nd > L ? nd : L;
  for (int j = 0; j < n; ++j) d[j] = j < nd ? din[j] : 0;

  // pass 1: exact carry
  i64 carry = 0;
  for (int j = 0; j < n; ++j) {
    i64 t = d[j] + carry;
    carry = t >> 8;
    d[j] = t - (carry << 8);
  }
  i64 c_out = carry;
  const i64 fold_c = R.def.prime
                         ? (R.def.bits == 256 ? 189 : 2)
                         : 0;  // 2^(8L) mod p  (p127: 2^128 mod (2^127-1) = 2)
  if (n > L) {
    // fold digits L.. with weight 2^(8(j-L)) * fold_c
    int nh = n - L;
    if (R.def.prime) {
      for (int j = 0; j < nh; ++j) d[j] += d[L + j] * fold_c;
      d[nh] += c_out * fold_c;
    }
    n = L;
  } else if (R.def.prime) {
    d[0] += c_out * fold_c;
  }
  for (int pass = 0; pass < 2; ++pass) {
    carry = 0;
    for (int j = 0; j < L; ++j) {
      i64 t = d[j] + carry;
      carry = t >> 8;
      d[j] = t - (carry << 8);
    }
    if (R.def.prime) d[0] += carry * fold_c;
  }
  carry = 0;
  for (int j = 0; j < L; ++j) {
    i64 t = d[j] + carry;
    carry = t >> 8;
    d[j] = t - (carry << 8);
  }
  if (R.def.prime) {
    // digits canonical [0,255]; subtract p while >= p (<= floor(2^(8L)/p)
    // times, which is 1 for both primes... p127 has 2^128/p127 = 2)
    const int reps = R.def.bits == 256 ? 1 : 2;
    // build p digits
    i64 pd[128];
    for (int j = 0; j < L; ++j) pd[j] = 0;
    // p = 2^bits - delta
    {
      // little-endian digits of p
      u64 plimbs[4];
      for (int w = 0; w < R.def.W; ++w) plimbs[w] = R.p[w];
      for (int w = 0; w < R.def.W; ++w) {
        u64 x = plimbs[w];
        for (int j = 0; j < 8; ++j) {
          pd[w * 8 + j] = (i64)(x & 0xff);
          x >>= 8;
        }
      }
    }
    for (int r = 0; r < reps; ++r) {
      i64 y[128];
      i64 borrow = 0;
      for (int j = 0; j < L; ++j) {
        i64 t = d[j] - pd[j] + borrow;
        borrow = t >> 8;
        y[j] = t - (borrow << 8);
      }
      if (borrow == 0)
        for (int j = 0; j < L; ++j) d[j] = y[j];
    }
  } else {
    // top digit mask
    int top_bits = R.def.bits - 8 * (L - 1);
    d[L - 1] &= (1 << top_bits) - 1;
  }
  for (int j = 0; j < L; ++j) out[j] = (i32)d[j];
}

}  // namespace

extern "C" {

// elementwise ops on canonical digit arrays [n, L] (int32)
void sfg_ring_add(int rid, const i32* a, const i32* b, i64 n, i32* out) {
  const RingOps& R = OPS[rid];
  const int L = R.def.L, W = R.def.W;
#pragma omp parallel for schedule(static) if (n > 4096)
  for (i64 i = 0; i < n; ++i) {
    u64 va[4], vb[4], vo[4];
    pack(a + i * L, L, va, W);
    pack(b + i * L, L, vb, W);
    R.add(va, vb, vo);
    unpack(vo, W, out + i * L);
  }
}

void sfg_ring_sub(int rid, const i32* a, const i32* b, i64 n, i32* out) {
  const RingOps& R = OPS[rid];
  const int L = R.def.L, W = R.def.W;
#pragma omp parallel for schedule(static) if (n > 4096)
  for (i64 i = 0; i < n; ++i) {
    u64 va[4], vb[4], vo[4];
    pack(a + i * L, L, va, W);
    pack(b + i * L, L, vb, W);
    R.sub(va, vb, vo);
    unpack(vo, W, out + i * L);
  }
}

void sfg_ring_neg(int rid, const i32* a, i64 n, i32* out) {
  const RingOps& R = OPS[rid];
  const int L = R.def.L, W = R.def.W;
#pragma omp parallel for schedule(static) if (n > 4096)
  for (i64 i = 0; i < n; ++i) {
    u64 va[4], vo[4];
    pack(a + i * L, L, va, W);
    R.neg(va, vo);
    unpack(vo, W, out + i * L);
  }
}

void sfg_ring_mul(int rid, const i32* a, const i32* b, i64 n, i32* out) {
  const RingOps& R = OPS[rid];
  const int L = R.def.L, W = R.def.W;
#pragma omp parallel for schedule(static) if (n > 2048)
  for (i64 i = 0; i < n; ++i) {
    u64 va[4], vb[4], vo[4];
    pack(a + i * L, L, va, W);
    pack(b + i * L, L, vb, W);
    R.mul(va, vb, vo);
    unpack(vo, W, out + i * L);
  }
}

// signed int64 digit arrays [n, nd] -> canonical [n, L]
void sfg_ring_reduce64(int rid, const i64* x, i64 n, int nd, i32* out) {
  const RingOps& R = OPS[rid];
  const int L = R.def.L;
  if (nd > 127) return;  // caller chunks
#pragma omp parallel for schedule(static) if (n > 2048)
  for (i64 i = 0; i < n; ++i) reduce_digits(R, x + i * nd, nd, out + i * L);
}

// out[i] = sum_k a[i, k] * c[k]   (a: [n, k, L], c: [k, L])
void sfg_ring_dot(int rid, const i32* a, const i32* c, i64 n, i64 k,
                  i32* out) {
  const RingOps& R = OPS[rid];
  const int L = R.def.L, W = R.def.W;
  // pre-pack the constants
  u64* cl = new u64[(size_t)k * W];
  for (i64 j = 0; j < k; ++j) pack(c + j * L, L, cl + j * W, W);
#pragma omp parallel for schedule(static) if (n > 512)
  for (i64 i = 0; i < n; ++i) {
    u64 acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};  // 2W + 1 limbs
    for (i64 j = 0; j < k; ++j) {
      u64 va[4], prod[8];
      pack(a + (i * k + j) * L, L, va, W);
      R.mul_wide(va, cl + j * W, prod);
      u128 cr = 0;
      for (int w = 0; w < 2 * W; ++w) {
        cr += (u128)acc[w] + prod[w];
        acc[w] = (u64)cr;
        cr >>= 64;
      }
      acc[2 * W] += (u64)cr;
    }
    // reduce (2W+1 limbs): fold top limb first via 2^(128W) ... easiest:
    // two-step fold_wide on (acc mod 2^(2W*64)) then add top*2^(2W*64) fold
    u64 vo[4];
    R.fold_wide(acc, vo);
    if (acc[2 * W] && R.def.prime) {
      // top * 2^(128W) mod p: for p256, 2^512 = 189^2; p127: 2^256 = 4
      u64 tl[4] = {0, 0, 0, 0};
      if (R.def.bits == 256) {
        u128 t = (u128)acc[8] * 189 * 189;
        tl[0] = (u64)t;
        tl[1] = (u64)(t >> 64);
      } else {
        u128 t = (u128)acc[4] * 4;
        tl[0] = (u64)t;
        tl[1] = (u64)(t >> 64);
      }
      u64 vt[4];
      R.canon(tl, 0);
      R.add(vo, tl, vt);
      for (int w = 0; w < W; ++w) vo[w] = vt[w];
    }
    unpack(vo, W, out + i * L);
  }
  delete[] cl;
}

// out[i,j] = sum_k A[i,k] * B[k,j]   (A: [r, k, L], B: [k, c, L])
void sfg_ring_matmul(int rid, const i32* A, const i32* B, i64 r, i64 k, i64 c,
                     i32* out) {
  const RingOps& R = OPS[rid];
  const int L = R.def.L, W = R.def.W;
  u64* Bl = new u64[(size_t)k * c * W];
  for (i64 j = 0; j < k * c; ++j) pack(B + j * L, L, Bl + j * W, W);
  u64* Al = new u64[(size_t)r * k * W];
  for (i64 j = 0; j < r * k; ++j) pack(A + j * L, L, Al + j * W, W);
#pragma omp parallel for schedule(static) if (r * c > 64)
  for (i64 ij = 0; ij < r * c; ++ij) {
    i64 i = ij / c, j = ij % c;
    u64 acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (i64 kk = 0; kk < k; ++kk) {
      u64 prod[8];
      R.mul_wide(Al + (i * k + kk) * W, Bl + (kk * c + j) * W, prod);
      u128 cr = 0;
      for (int w = 0; w < 2 * W; ++w) {
        cr += (u128)acc[w] + prod[w];
        acc[w] = (u64)cr;
        cr >>= 64;
      }
      acc[2 * W] += (u64)cr;
    }
    u64 vo[4];
    R.fold_wide(acc, vo);
    if (acc[2 * W] && R.def.prime) {
      u64 tl[4] = {0, 0, 0, 0};
      if (R.def.bits == 256) {
        u128 t = (u128)acc[8] * 189 * 189;
        tl[0] = (u64)t;
        tl[1] = (u64)(t >> 64);
      } else {
        u128 t = (u128)acc[4] * 4;
        tl[0] = (u64)t;
        tl[1] = (u64)(t >> 64);
      }
      u64 vt[4];
      R.canon(tl, 0);
      R.add(vo, tl, vt);
      for (int w = 0; w < W; ++w) vo[w] = vt[w];
    }
    unpack(vo, W, out + ij * L);
  }
  delete[] Al;
  delete[] Bl;
}

}  // extern "C"
