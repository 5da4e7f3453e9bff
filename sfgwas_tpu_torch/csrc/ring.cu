// Kernels K8-K11: the SS ring's device path, base-2^8 digit arithmetic
// modulo p256 = 2^256 - 189, p127 = 2^127 - 1, 2^256 and 2^127.
//
// Replaces sfgwas_tpu/ops/ring.py's jitted device programs (XLA, no Pallas
// kernel): K8 ring_reduce _reduce_dev (:389, with _exact_carry :368 and
// _cond_sub_p :435), which add, sub, neg, mul_int, sum and from_i32 end in;
// K9 ring_mul _mul_dev (:522); K10 ring_matmul _matmul_dev (:590); K11
// ring_dot _dot_coeffs_dev (:653).
//
// What they compute.  An element is L = 32 (p256, 2^256) or 16 (p127,
// 2^127) int32 digits, little-endian base 2^8.  K8 takes any signed digit
// array [n, nd], nd <= 2L - 1, and writes the canonical digits of its value
// modulo the ring's modulus; K9 the elementwise product of canonical
// arrays [n, L]; K10 [r, k, L] x [k, c, L] -> [r, c, L] for any k; K11
// sum_k a[i, k] * coeffs[k] over [n, k, L] and [k, L].  A canonical value
// has one digit form, so each is bit-equal to the JAX function wherever
// that is exact (its int32 carries do not overflow).
//
// The design.  One thread an output element.  Four digits make one 32-bit
// word, so a canonical row is L/4 words read with L/16 16-byte loads.  A
// product is a schoolbook over the words with 32x32->64 multiply-adds and
// 64-bit carries (K9: 2W words; K10 and K11 add every term's 2W words into
// a 2W + 1 word sum, exact for up to 2^32 terms, so k needs no chunks).
// Every result is brought to canonical form once, by canon(): carry the
// signed words, fold the words at and above 2^(32W) back with 2^(32W) =
// 189 (p256) or 2 (p127) mod p until none is left, subtract p while the
// value is at least p; the power-of-two rings drop those words and mask
// the top word.
//
// What bounds them on the H100.  K8 and K9 move 4 bytes a digit and do
// little work (K9: W^2 = 64 word products a p256 element): bytes.  K10 and
// K11 do W^2 word products a term; at the SS protocol's shapes (6 x 6
// matrices, the normaliser's k = 37 terms a value) they are small, and the
// launch dominates.  This is the simple kernel first: no shared memory, no
// tensor cores.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

// the ring's constants; RING as in native/ring.cpp: 0 p256, 1 p127, 2 2^256, 3 2^127
template <int RING>
struct RingDef {
    static constexpr int W = (RING == 0 || RING == 2) ? 8 : 4;  // 32-bit words
    static constexpr int L = 4 * W;                             // digits
    static constexpr bool PRIME = RING < 2;
    static constexpr int64_t FOLD = RING == 0 ? 189 : 2;  // 2^(32W) mod p
    static constexpr uint32_t TOP = RING == 3 ? 0x7fffffffu : 0xffffffffu;  // pow2 top word
    // p's words: 2^256 - 189 and 2^127 - 1
    __device__ static uint32_t p(int i) {
        if (RING == 0) return i == 0 ? 0xffffff43u : 0xffffffffu;
        return i == W - 1 ? 0x7fffffffu : 0xffffffffu;
    }
};

// x[0..NX) signed 32-bit-word lazy sums (value sum x[i] 2^(32 i), each
// |x[i]| < 2^62) -> the canonical words of value mod the ring's modulus
template <int RING, int NX>
__device__ __forceinline__ void canon(int64_t (&x)[NX], uint32_t (&o)[RingDef<RING>::W]) {
    using R = RingDef<RING>;
    constexpr int W = R::W;
    static_assert(NX > W && NX - W < NX, "canon: too few words");
    int64_t c = 0;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
        const int64_t t = x[i] + c;
        x[i] = t & 0xffffffffll;
        c = t >> 32;
    }
    if (R::PRIME) {
        // value = x + c 2^(32 NX); fold everything at and above 2^(32 W)
        for (int it = 0; it < 16; ++it) {
            bool high = c != 0;
#pragma unroll
            for (int i = W; i < NX; ++i) high |= x[i] != 0;
            if (!high) break;
            int64_t hi[NX - W];
#pragma unroll
            for (int i = 0; i < NX - W; ++i) {
                hi[i] = x[W + i];
                x[W + i] = 0;
            }
#pragma unroll
            for (int i = 0; i < NX - W; ++i) x[i] += R::FOLD * hi[i];
            x[NX - W] += R::FOLD * c;
            c = 0;
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                const int64_t t = x[i] + c;
                x[i] = t & 0xffffffffll;
                c = t >> 32;
            }
        }
        // 0 <= value < 2^(32 W): subtract p while value >= p (at most twice)
#pragma unroll
        for (int rep = 0; rep < 2; ++rep) {
            int64_t b = 0;
            uint32_t y[W];
#pragma unroll
            for (int i = 0; i < W; ++i) {
                const int64_t t = x[i] - (int64_t)R::p(i) + b;
                y[i] = (uint32_t)(t & 0xffffffffll);
                b = t >> 32;
            }
            if (b == 0) {
#pragma unroll
                for (int i = 0; i < W; ++i) x[i] = y[i];
            }
        }
#pragma unroll
        for (int i = 0; i < W; ++i) o[i] = (uint32_t)x[i];
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) o[i] = (uint32_t)x[i];
        o[W - 1] &= R::TOP;
    }
}

template <int W>
__device__ __forceinline__ void load_words(const int* __restrict__ row, uint32_t (&v)[W]) {
    const int4* q = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int i = 0; i < W; ++i) {
        const int4 d = __ldg(q + i);
        v[i] = (uint32_t)d.x | ((uint32_t)d.y << 8) | ((uint32_t)d.z << 16) | ((uint32_t)d.w << 24);
    }
}

template <int W>
__device__ __forceinline__ void store_digits(int* __restrict__ row, const uint32_t (&v)[W]) {
    int4* q = reinterpret_cast<int4*>(row);
#pragma unroll
    for (int i = 0; i < W; ++i)
        q[i] = make_int4(v[i] & 0xff, (v[i] >> 8) & 0xff, (v[i] >> 16) & 0xff, v[i] >> 24);
}

// acc[0..2W] += a * b (2W + 1 words; the top word counts the overflow of a sum)
template <int W>
__device__ __forceinline__ void mul_acc(uint32_t (&acc)[2 * W + 1], const uint32_t (&a)[W],
                                        const uint32_t (&b)[W]) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
        uint64_t carry = 0;
#pragma unroll
        for (int j = 0; j < W; ++j) {
            const uint64_t t = (uint64_t)a[i] * b[j] + acc[i + j] + carry;
            acc[i + j] = (uint32_t)t;
            carry = t >> 32;
        }
#pragma unroll
        for (int m = i + W; m <= 2 * W; ++m) {
            const uint64_t t = (uint64_t)acc[m] + carry;
            acc[m] = (uint32_t)t;
            carry = t >> 32;
        }
    }
}

template <int RING>
__device__ __forceinline__ void canon_acc(const uint32_t (&acc)[2 * RingDef<RING>::W + 1],
                                          int* __restrict__ out) {
    constexpr int W = RingDef<RING>::W;
    int64_t x[2 * W + 2];
#pragma unroll
    for (int i = 0; i <= 2 * W; ++i) x[i] = acc[i];
    x[2 * W + 1] = 0;
    uint32_t o[W];
    canon<RING>(x, o);
    store_digits<W>(out, o);
}

// K8: signed digits [n, nd] (nd <= 2L - 1) -> canonical [n, L]
template <int RING>
__global__ void __launch_bounds__(THREADS)
ring_reduce_kernel(const int* __restrict__ xin, int* __restrict__ out, const long long n,
                   const int nd) {
    constexpr int W = RingDef<RING>::W;
    const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (e >= n) return;
    const int* row = xin + e * nd;
    int64_t x[2 * W + 2];
#pragma unroll
    for (int w = 0; w < 2 * W + 2; ++w) {
        int64_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int d = 4 * w + j;
            if (d < nd) v += (int64_t)__ldg(row + d) * ((int64_t)1 << (8 * j));
        }
        x[w] = v;
    }
    uint32_t o[W];
    canon<RING>(x, o);
    store_digits<W>(out + e * RingDef<RING>::L, o);
}

// K9: canonical a, b [n, L] -> a * b [n, L]
template <int RING>
__global__ void __launch_bounds__(THREADS)
ring_mul_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                const long long n) {
    constexpr int W = RingDef<RING>::W, L = RingDef<RING>::L;
    const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (e >= n) return;
    uint32_t va[W], vb[W], acc[2 * W + 1];
    load_words<W>(a + e * L, va);
    load_words<W>(b + e * L, vb);
#pragma unroll
    for (int i = 0; i <= 2 * W; ++i) acc[i] = 0;
    mul_acc<W>(acc, va, vb);
    canon_acc<RING>(acc, out + e * L);
}

// sum_t A[i, t] * B[t, j] over t < k: A rows of stride k*L, B rows of stride c*L
template <int RING>
__device__ __forceinline__ void dot_terms(const int* __restrict__ A, const int* __restrict__ B,
                                          const int k, const int c, int* __restrict__ out) {
    constexpr int W = RingDef<RING>::W, L = RingDef<RING>::L;
    uint32_t acc[2 * W + 1];
#pragma unroll
    for (int i = 0; i <= 2 * W; ++i) acc[i] = 0;
    for (int t = 0; t < k; ++t) {
        uint32_t va[W], vb[W];
        load_words<W>(A + (long long)t * L, va);
        load_words<W>(B + (long long)t * c * L, vb);
        mul_acc<W>(acc, va, vb);
    }
    canon_acc<RING>(acc, out);
}

// K10: [r, k, L] x [k, c, L] -> [r, c, L]
template <int RING>
__global__ void __launch_bounds__(THREADS)
ring_matmul_kernel(const int* __restrict__ A, const int* __restrict__ B, int* __restrict__ out,
                   const int r, const int k, const int c) {
    constexpr int L = RingDef<RING>::L;
    const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (e >= (long long)r * c) return;
    const long long i = e / c, j = e % c;
    dot_terms<RING>(A + i * k * L, B + j * L, k, c, out + e * L);
}

// K11: a [n, k, L], coeffs [k, L] -> [n, L]
template <int RING>
__global__ void __launch_bounds__(THREADS)
ring_dot_kernel(const int* __restrict__ a, const int* __restrict__ coeffs, int* __restrict__ out,
                const long long n, const int k) {
    constexpr int L = RingDef<RING>::L;
    const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (e >= n) return;
    dot_terms<RING>(a + e * k * L, coeffs, k, 1, out + e * L);
}

inline unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

#define RING_SWITCH(ring, CALL)                  \
    switch (ring) {                              \
        case 0: CALL(0); break;                  \
        case 1: CALL(1); break;                  \
        case 2: CALL(2); break;                  \
        case 3: CALL(3); break;                  \
        default: return (int)cudaErrorInvalidValue; \
    }

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// x [n, nd] int32 (any sign, 1 <= nd <= 2L - 1) -> out [n, L] canonical
int ring_reduce(int ring, const void* x, void* out, long long n, int nd, void* stream) {
    const int L = (ring == 0 || ring == 2) ? 32 : 16;
    if (n < 1 || nd < 1 || nd > 2 * L - 1 || n > 0x7fffffffll * THREADS || !aligned(out))
        return (int)cudaErrorInvalidValue;
#define CALL(R)                                                                        \
    ring_reduce_kernel<R><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(            \
        (const int*)x, (int*)out, n, nd)
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

// a, b, out [n, L] int32, canonical, 16-byte aligned
int ring_mul(int ring, const void* a, const void* b, void* out, long long n, void* stream) {
    if (n < 1 || n > 0x7fffffffll * THREADS || !aligned(a) || !aligned(b) || !aligned(out))
        return (int)cudaErrorInvalidValue;
#define CALL(R)                                                                        \
    ring_mul_kernel<R><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(               \
        (const int*)a, (const int*)b, (int*)out, n)
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

// A [r, k, L], B [k, c, L], out [r, c, L] int32, canonical, 16-byte aligned; k < 2^32
int ring_matmul(int ring, const void* A, const void* B, void* out, int r, int k, int c,
                void* stream) {
    const long long n = (long long)r * c;
    if (r < 1 || c < 1 || k < 1 || n > 0x7fffffffll * THREADS || !aligned(A) || !aligned(B) ||
        !aligned(out))
        return (int)cudaErrorInvalidValue;
#define CALL(R)                                                                        \
    ring_matmul_kernel<R><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(            \
        (const int*)A, (const int*)B, (int*)out, r, k, c)
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

// a [n, k, L], coeffs [k, L], out [n, L] int32, canonical, 16-byte aligned
int ring_dot(int ring, const void* a, const void* coeffs, void* out, long long n, int k,
             void* stream) {
    if (n < 1 || k < 1 || n > 0x7fffffffll * THREADS || !aligned(a) || !aligned(coeffs) ||
        !aligned(out))
        return (int)cudaErrorInvalidValue;
#define CALL(R)                                                                        \
    ring_dot_kernel<R><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(               \
        (const int*)a, (const int*)coeffs, (int*)out, n, k)
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

}  // extern "C"
