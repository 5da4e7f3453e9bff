// Kernels K8-K11: the SS ring's device path, base-2^8 digit arithmetic
// modulo p256 = 2^256 - 189, p127 = 2^127 - 1, 2^256 and 2^127.
//
// Replaces sfgwas_tpu/ops/ring.py's jitted device programs (XLA, no Pallas
// kernel): K8 ring_reduce _reduce_dev (:389, with _exact_carry :368 and
// _cond_sub_p :435), and K8's fused entries, each one program there and one
// launch here: ring_combine _add_dev (:475), _sub_dev (:488), _neg_dev
// (:507) and mul_int's small-constant reduce (:555), ring_sum _sum_dev
// (:671), ring_from_i32 from_i32's device branch (:285-290); K9 ring_mul
// _mul_dev (:522, and _mul_const_dev :546 through it); K10 ring_matmul
// _matmul_dev (:590); K11 ring_dot _dot_coeffs_dev (:653).
//
// What they compute.  An element is L = 32 (p256, 2^256) or 16 (p127,
// 2^127) int32 digits, little-endian base 2^8.  K8 takes any signed digit
// array [n, nd], nd <= 2L - 1, and writes the canonical digits of its value
// modulo the ring's modulus; its entries the canonical sa a + sb b of
// canonical rows (|sa|, |sb| < 2^9; add, sub, neg, small mul_int), the sum
// of k canonical rows, the digits of an int32; K9 the elementwise product of
// canonical rows; K10 [r, k, L] x [k, c, L] -> [r, c, L] for any k; K11
// sum_k a[i, k] * coeffs[k] over [n, k, L] and [k, L].  A canonical value
// has one digit form, so each is bit-equal to the JAX function wherever
// that is exact (its int32 carries do not overflow).
//
// The arithmetic.  One thread an output element (K10: one warp, below).
// Four digits make one 32-bit word.  A product is a schoolbook over the
// words with 32x32->64 multiply-adds and 64-bit carries (K9: 2W words; K11
// adds every term's 2W words into a 2W + 1 word sum, exact for up to 2^32
// terms, so k needs no chunks; K10 keeps 64-bit column sums instead).  Every result is brought to canonical form once, by
// canon(): carry the signed words, fold the words at and above 2^(32W) back
// with 2^(32W) = 189 (p256) or 2 (p127) mod p until none is left, subtract
// p while the value is at least p; the power-of-two rings drop those words
// and mask the top word.
//
// What bounds them on the H100.  K8 and K9 move 4 bytes a digit and do
// little work (K9: W^2 = 64 word products a p256 element): bytes.  A row is
// 128 bytes (64 at p127), so one thread reading or writing its own row
// leaves a warp's lanes a row apart, 32 cache lines an access.  K8 and K9
// therefore stage a block's rows in shared memory: coalesced loads (16-byte
// chunks, consecutive lanes on consecutive chunks; cp.async for K8) into a
// tile whose rows a thread reads without bank conflicts (an odd row stride,
// or the XOR swizzle swz()), and coalesced 16-byte stores out of a swizzled
// tile.  K8's entries do their elementwise step (the signed combination, the
// k-term sum in 64 bits, the int32's digits) inside the launch, so no
// intermediate goes to device memory.  An operand broadcast or transposed
// (a constant row, [c, 1, L] against [c, n, L], a matrix's transpose) is
// read in place from its axes' sizes and strides (Rows).  K10 and K11 do
// W^2 word products a term.  K11 (the normaliser's k = 37 terms a value at
// n = 99,337) streams its rows at 71% of its bytes' bound and stays the
// simple kernel.  K10's shapes are tiny (6 x 6 matrices): its time is one
// output element's chain of dependent instructions, which its warp-wide
// design below shortens.

#include <algorithm>

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

// ---- K8 and K9's staged tiles
//
// A block's THREADS elements are THREADS consecutive output rows.  Their
// inputs reach shared memory with coalesced loads (consecutive threads on
// consecutive 16-byte chunks, or cp.async), each thread then works on its
// own row there, and the block's output rows leave through shared memory as
// coalesced 16-byte stores.

// a word tile: THREADS rows of W 32-bit words, word w of row r at
// r W + (w ^ f(r)), f(r) = (r / (32 / W)) mod W.  A thread reading its own
// row a word at a time and a warp reading 32 consecutive words each touch 32
// distinct banks.
template <int W>
__device__ __forceinline__ int swz(int r, int w) {
    return r * W + (w ^ ((r / (32 / W)) & (W - 1)));
}

// the same for 64-bit words, 16 to a conflict-free half-warp access
template <int W>
__device__ __forceinline__ int swz64(int r, int w) {
    return r * W + (w ^ ((r / (16 / W)) & (W - 1)));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// the 32-bit word of the 4 canonical digits at p (16-byte aligned when vec)
__device__ __forceinline__ uint32_t word_at(const int* __restrict__ p, const bool vec) {
    const int4 d = vec ? __ldg(reinterpret_cast<const int4*>(p))
                       : make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    return (uint32_t)d.x | ((uint32_t)d.y << 8) | ((uint32_t)d.z << 16) | ((uint32_t)d.w << 24);
}

// where an operand read in place keeps its rows: output element e, over
// the output's batch axes, is (i_0, .., i_{nd-1}) over `size` (innermost
// last), and its row starts at sum_d i_d stride[d] int32s.  A broadcast axis
// has stride 0, a transposed one its own; nd <= MAXD after the wrapper has
// merged the axes it can.
constexpr int MAXD = 4;
struct Rows {
    long long size[MAXD], stride[MAXD];
    int nd;
};

// the row offset of element e: the axes are indexed by constants only (a
// loop to a runtime axis count with 64-bit division ran K9 1.5x slower on an
// H100), and e < 2^31, as the launchers check, so the index is 32-bit
__device__ __forceinline__ long long row_offset(const Rows& g, long long e) {
    unsigned i = (unsigned)e;
    long long off = 0;
#pragma unroll
    for (int d = MAXD - 1; d > 0; --d) {
        if (d < g.nd) {
            const unsigned size = (unsigned)g.size[d], q = i / size;
            off += (long long)(i - q * size) * g.stride[d];
            i = q;
        }
    }
    return off + (long long)i * g.stride[0];
}

// the words of the block's rows (rows[r] the offset of row r) of a
// canonical operand into a word tile; all loads issued before the stores
template <int W>
__device__ __forceinline__ void stage_words(uint32_t* tile, const int* __restrict__ src,
                                            const long long* rows, const int nrows,
                                            const bool vec) {
    uint32_t v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int c = threadIdx.x + j * THREADS;
        v[j] = c < nrows * W ? word_at(src + rows[c / W] + 4 * (c % W), vec) : 0u;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int c = threadIdx.x + j * THREADS;
        if (c < nrows * W) tile[swz<W>(c / W, c % W)] = v[j];
    }
}

// this thread's canonical words o (row threadIdx.x, where mine) into the
// word tile, then the block's nrows rows to out (their first) as coalesced
// 16-byte stores of 4 digits
template <int W>
__device__ __forceinline__ void store_rows(uint32_t* tile, const uint32_t (&o)[W],
                                           const bool mine, const int nrows,
                                           int* __restrict__ out) {
    __syncthreads();  // every thread is done reading the tile
    if (mine) {
#pragma unroll
        for (int w = 0; w < W; ++w) tile[swz<W>(threadIdx.x, w)] = o[w];
    }
    __syncthreads();
    int4* q = reinterpret_cast<int4*>(out);
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int c = threadIdx.x + j * THREADS;
        if (c < nrows * W) {
            const uint32_t v = tile[swz<W>(c / W, c % W)];
            q[c] = make_int4(v & 0xff, (v >> 8) & 0xff, (v >> 16) & 0xff, v >> 24);
        }
    }
}

// K8: signed digits [n, nd] (nd <= 2L - 1) -> canonical [n, L].  The block's
// run of THREADS nd digits is copied into a tile of odd row stride: in
// 16-byte cp.async chunks read back 16 bytes at a time where nd % 4 == 0 and
// the run is 16-byte aligned (vec), else digit by digit (4-byte cp.async).
template <int RING>
__global__ void __launch_bounds__(THREADS)
ring_reduce_kernel(const int* __restrict__ xin, int* __restrict__ out, const long long n,
                   const int nd, const bool vec) {
    constexpr int W = RingDef<RING>::W, L = RingDef<RING>::L;
    extern __shared__ int4 smem[];
    int* tile = reinterpret_cast<int*>(smem);
    const long long e0 = (long long)blockIdx.x * THREADS;
    const int nrows = (int)min((long long)THREADS, n - e0), t = threadIdx.x;
    const int* src = xin + e0 * nd;
    // a row's units (chunks or digits) and the tile's odd row stride in units;
    // r = c / q as umulhi(c, ceil(2^32 / q)), exact for c, q < 2^16
    const int q = vec ? nd / 4 : nd, s = q | 1;
    const uint32_t m = q == 1 ? 0u : (uint32_t)((0x100000000ull + q - 1) / q);
    for (int c = t; c < nrows * q; c += THREADS) {
        const int r = q == 1 ? c : (int)__umulhi((uint32_t)c, m), j = c - r * q;
        if (vec)
            cp_async16(smem + r * s + j, src + 4 * c);
        else
            cp_async4(tile + r * s + j, src + c);
    }
    cp_async_wait_all();
    __syncthreads();
    const bool mine = t < nrows;
    uint32_t o[W] = {};
    if (mine) {
        int64_t x[2 * W + 2];
        if (vec) {
#pragma unroll
            for (int w = 0; w < 2 * W + 2; ++w) {
                x[w] = 0;
                if (4 * w < nd) {
                    const int4 d = smem[t * s + w];
                    x[w] = (int64_t)d.x + (int64_t)d.y * (1 << 8) + (int64_t)d.z * (1 << 16) +
                           (int64_t)d.w * (1 << 24);
                }
            }
        } else {
#pragma unroll
            for (int w = 0; w < 2 * W + 2; ++w) {
                int64_t v = 0;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int d = 4 * w + j;
                    if (d < nd) v += (int64_t)tile[t * s + d] * ((int64_t)1 << (8 * j));
                }
                x[w] = v;
            }
        }
        canon<RING>(x, o);
    }
    store_rows<W>(reinterpret_cast<uint32_t*>(smem), o, mine, nrows, out + e0 * L);
}

// K8's combine entry: canonical a, b (b may be null) -> canon(sa a + sb b),
// |sa|, |sb| < 2^9; operand rows where ag, bg put them
template <int RING>
__global__ void __launch_bounds__(THREADS)
ring_combine_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                    const long long n, const Rows ag, const Rows bg, const int sa, const int sb,
                    const bool avec, const bool bvec) {
    constexpr int W = RingDef<RING>::W, L = RingDef<RING>::L;
    __shared__ uint32_t ta[THREADS * W], tb[THREADS * W];
    __shared__ long long rows[2][THREADS];
    const long long e0 = (long long)blockIdx.x * THREADS;
    const int nrows = (int)min((long long)THREADS, n - e0), t = threadIdx.x;
    const bool mine = t < nrows;
    if (mine) {
        rows[0][t] = row_offset(ag, e0 + t);
        rows[1][t] = row_offset(bg, e0 + t);
    }
    __syncthreads();
    stage_words<W>(ta, a, rows[0], nrows, avec);
    if (b) stage_words<W>(tb, b, rows[1], nrows, bvec);
    __syncthreads();
    uint32_t o[W] = {};
    if (mine) {
        int64_t x[W + 1];
#pragma unroll
        for (int w = 0; w < W; ++w) {
            x[w] = (int64_t)sa * ta[swz<W>(t, w)];
            if (b) x[w] += (int64_t)sb * tb[swz<W>(t, w)];
        }
        x[W] = 0;
        canon<RING>(x, o);
    }
    store_rows<W>(ta, o, mine, nrows, out + e0 * L);
}

// K8's sum entry: canonical a viewed as [outer, k, inner, L] -> the sums over
// k, [outer, inner, L] (n = outer inner elements), k < 2^22: a thread adds
// the same 16-byte chunks of every term in 64 bits, coalesced
template <int RING>
__global__ void __launch_bounds__(THREADS)
ring_sum_kernel(const int* __restrict__ a, int* __restrict__ out, const long long n, const int k,
                const long long inner, const bool vec) {
    constexpr int W = RingDef<RING>::W, L = RingDef<RING>::L;
    __shared__ int64_t ts[THREADS * W];
    __shared__ long long base[THREADS];
    const long long e0 = (long long)blockIdx.x * THREADS;
    const int nrows = (int)min((long long)THREADS, n - e0), t = threadIdx.x;
    const bool mine = t < nrows;
    if (mine) {
        const long long e = e0 + t, o = inner == 1 ? e : e / inner;
        base[t] = (o * k * inner + (e - o * inner)) * L;
    }
    __syncthreads();
    int64_t acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0;
    const long long step = inner * L;
    for (int s = 0; s < k; ++s) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
            const int c = t + j * THREADS;
            if (c < nrows * W) acc[j] += word_at(a + base[c / W] + s * step + 4 * (c % W), vec);
        }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int c = t + j * THREADS;
        if (c < nrows * W) ts[swz64<W>(c / W, c % W)] = acc[j];
    }
    __syncthreads();
    uint32_t o[W] = {};
    if (mine) {
        int64_t x[W + 1];
#pragma unroll
        for (int w = 0; w < W; ++w) x[w] = ts[swz64<W>(t, w)];
        x[W] = 0;
        canon<RING>(x, o);
    }
    store_rows<W>(reinterpret_cast<uint32_t*>(ts), o, mine, nrows, out + e0 * L);
}

// K8's from_i32 entry: int32 v [n] -> the canonical digits of v mod 2^32
template <int RING>
__global__ void __launch_bounds__(THREADS)
ring_from_i32_kernel(const int* __restrict__ v, int* __restrict__ out, const long long n) {
    constexpr int W = RingDef<RING>::W, L = RingDef<RING>::L;
    __shared__ uint32_t tile[THREADS * W];
    const long long e0 = (long long)blockIdx.x * THREADS;
    const int nrows = (int)min((long long)THREADS, n - e0), t = threadIdx.x;
    const bool mine = t < nrows;
    uint32_t o[W] = {};
    if (mine) {
        int64_t x[W + 1];
#pragma unroll
        for (int w = 0; w <= W; ++w) x[w] = 0;
        x[0] = (uint32_t)__ldg(v + e0 + t);
        canon<RING>(x, o);
    }
    store_rows<W>(tile, o, mine, nrows, out + e0 * L);
}

// K9: canonical a, b -> a * b [n, L], operand rows where ag, bg put them
template <int RING>
__global__ void __launch_bounds__(THREADS)
ring_mul_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                const long long n, const Rows ag, const Rows bg, const bool avec,
                const bool bvec) {
    constexpr int W = RingDef<RING>::W, L = RingDef<RING>::L;
    __shared__ uint32_t ta[THREADS * W], tb[THREADS * W];
    __shared__ long long rows[2][THREADS];
    const long long e0 = (long long)blockIdx.x * THREADS;
    const int nrows = (int)min((long long)THREADS, n - e0), t = threadIdx.x;
    const bool mine = t < nrows;
    if (mine) {
        rows[0][t] = row_offset(ag, e0 + t);
        rows[1][t] = row_offset(bg, e0 + t);
    }
    __syncthreads();
    stage_words<W>(ta, a, rows[0], nrows, avec);
    stage_words<W>(tb, b, rows[1], nrows, bvec);
    __syncthreads();
    uint32_t o[W] = {};
    if (mine) {
        uint32_t va[W], vb[W], acc[2 * W + 1];
#pragma unroll
        for (int w = 0; w < W; ++w) {
            va[w] = ta[swz<W>(t, w)];
            vb[w] = tb[swz<W>(t, w)];
        }
#pragma unroll
        for (int i = 0; i <= 2 * W; ++i) acc[i] = 0;
        mul_acc<W>(acc, va, vb);
        int64_t x[2 * W + 2];
#pragma unroll
        for (int i = 0; i <= 2 * W; ++i) x[i] = acc[i];
        x[2 * W + 1] = 0;
        canon<RING>(x, o);
    }
    store_rows<W>(ta, o, mine, nrows, out + e0 * L);
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

// ---- K10: a warp an output element
//
// The first design ran one thread an output element: k terms of mul_acc, W^2
// dependent multiply-adds and a carry ripple through the top words after
// every row of the schoolbook, then canon's signed ripples, one chain of
// about two thousand dependent instructions at 6 x 6 x 6 with every term's
// loads waiting on the previous term's products.  Here the warp's 32 lanes
// split the work of one output element: lane l takes row l % W of the
// schoolbook (word l % W of A[i, t] times B[t, j]'s W words) for the terms
// t = l / W, l / W + 32 / W, ..., the next term's words loaded before the
// current one's products.  Each product's halves go into 64-bit column sums
// that need no ripple (a column gets at most 2W halves a term, so below
// 2^63 for k <= MATMUL_MAX_K).  The lanes of one row add their sums by
// shuffles, the rows' sums meet in shared memory as the 2W + 1 column sums
// of the whole sum, and one lane carries them into words and reduces them
// once (canon_cols: 32-bit words with 64-bit carries, no signed words).
// On an H100 at 6 x 6 x 6 (LElem256) this took the launch from 0.0061 ms
// to 0.0027, an empty kernel's being 0.0008, and 3 x 900 x 2 from 0.62 to
// 0.064.  The design is for few outputs, as the SS protocol's products
// (6 x 6 and smaller) have: at many outputs and small k the warp's one
// reducing lane would cost 32 times the issue slots of a thread an element.

constexpr int MM_WARPS = 4;                // output elements a block
constexpr long long MATMUL_MAX_K = 1 << 27;  // 16 k 2^32 < 2^63

// the canonical words of sum_m col[m] 2^(32 m) mod the ring's modulus, for
// col[m] < 2^63
template <int RING>
__device__ __forceinline__ void canon_cols(const uint64_t (&col)[2 * RingDef<RING>::W + 1],
                                           uint32_t (&o)[RingDef<RING>::W]) {
    using R = RingDef<RING>;
    constexpr int W = R::W, NX = 2 * W + 2;
    // word m: the low half of col[m], the high half of col[m - 1] and the
    // carry (below 3); the value is below 2^(32 NX), so nothing is left over
    uint32_t x[NX];
    uint32_t c = 0;
#pragma unroll
    for (int m = 0; m < NX; ++m) {
        const uint64_t t = (uint64_t)(m < NX - 1 ? (uint32_t)col[m] : 0u) +
                           (m > 0 ? (uint32_t)(col[m - 1] >> 32) : 0u) + c;
        x[m] = (uint32_t)t;
        c = (uint32_t)(t >> 32);
    }
    if (R::PRIME) {
        // value = low + 2^(32 W) high = low + FOLD high mod p, until high is 0
        // (p256: 576 -> 328 -> 257 bits, then 2^256 + a small value at most twice)
        for (int it = 0; it < 16; ++it) {
            uint32_t high = 0;
#pragma unroll
            for (int m = W; m < NX; ++m) high |= x[m];
            if (!high) break;
            c = 0;
#pragma unroll
            for (int m = 0; m < NX; ++m) {
                // x[W + m] is read here before step W + m writes it
                const uint64_t t = (uint64_t)(m < W ? x[m] : 0u) +
                                   (m < NX - W ? (uint64_t)R::FOLD * x[W + m] : 0ull) + c;
                x[m] = (uint32_t)t;
                c = (uint32_t)(t >> 32);
            }
        }
        // 0 <= value < 2^(32 W): subtract p while value >= p (at most twice)
#pragma unroll
        for (int rep = 0; rep < 2; ++rep) {
            uint32_t y[W], borrow = 0;
#pragma unroll
            for (int m = 0; m < W; ++m) {
                const uint64_t t = (uint64_t)x[m] - R::p(m) - borrow;
                y[m] = (uint32_t)t;
                borrow = (uint32_t)(t >> 63);
            }
            if (!borrow) {
#pragma unroll
                for (int m = 0; m < W; ++m) x[m] = y[m];
            }
        }
    }
#pragma unroll
    for (int m = 0; m < W; ++m) o[m] = x[m];
    if (!R::PRIME) o[W - 1] &= R::TOP;
}

__device__ __forceinline__ uint32_t load_word(const int* __restrict__ digits) {
    const int4 d = __ldg(reinterpret_cast<const int4*>(digits));
    return (uint32_t)d.x | ((uint32_t)d.y << 8) | ((uint32_t)d.z << 16) | ((uint32_t)d.w << 24);
}

// K10: [r, k, L] x [k, c, L] -> [r, c, L]
template <int RING>
__global__ void __launch_bounds__(MM_WARPS * 32)
ring_matmul_kernel(const int* __restrict__ A, const int* __restrict__ B, int* __restrict__ out,
                   const int r, const int k, const int c) {
    using R = RingDef<RING>;
    constexpr int W = R::W, L = R::L, SLOTS = 32 / W;
    __shared__ uint64_t part[MM_WARPS][W][W + 1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long e = (long long)blockIdx.x * MM_WARPS + warp;
    if (e >= (long long)r * c) return;  // the whole warp
    const long long i = e / c, j = e % c;
    const int row = lane % W, slot = lane / W;
    const int* a = A + i * k * L + 4 * row;  // word `row` of A[i, t] at a + t L
    const int* b = B + j * L;                // B[t, j] at b + t c L
    const long long bstep = (long long)c * L;
    // acc[m]: this lane's column row + m
    uint64_t acc[W + 1];
#pragma unroll
    for (int m = 0; m <= W; ++m) acc[m] = 0;
    uint32_t an = 0, bn[W] = {};
    if (slot < k) {
        an = load_word(a + (long long)slot * L);
        load_words<W>(b + slot * bstep, bn);
    }
    for (int t = slot; t < k; t += SLOTS) {
        const uint32_t av = an;
        uint32_t bv[W];
#pragma unroll
        for (int m = 0; m < W; ++m) bv[m] = bn[m];
        if (t + SLOTS < k) {
            an = load_word(a + (long long)(t + SLOTS) * L);
            load_words<W>(b + (t + SLOTS) * bstep, bn);
        }
#pragma unroll
        for (int m = 0; m < W; ++m) {
            const uint64_t p = (uint64_t)av * bv[m];
            acc[m] += (uint32_t)p;
            acc[m + 1] += p >> 32;
        }
    }
    // the row's sums over its term slots (lanes row, row + W, ...)
#pragma unroll
    for (int off = W; off < 32; off <<= 1) {
#pragma unroll
        for (int m = 0; m <= W; ++m) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
    }
    if (slot == 0) {
#pragma unroll
        for (int m = 0; m <= W; ++m) part[warp][row][m] = acc[m];
    }
    __syncwarp();
    // lane m < 2W + 1: column m of the whole sum, from the rows that reach it
    uint64_t mine = 0;
    if (lane <= 2 * W) {
        for (int rr = lane > W ? lane - W : 0; rr < W && rr <= lane; ++rr)
            mine += part[warp][rr][lane - rr];
    }
    uint64_t col[2 * W + 1];
#pragma unroll
    for (int m = 0; m <= 2 * W; ++m) col[m] = __shfl_sync(0xffffffffu, mine, m);
    if (lane == 0) {
        uint32_t o[W];
        canon_cols<RING>(col, o);
        store_digits<W>(out + e * L, o);
    }
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

// an operand's Rows from {nd, size[0..nd), stride[0..nd)} (1 <= nd <= MAXD,
// sizes in [1, 2^31), strides >= 0)
bool rows_of(const long long* geom, Rows& g) {
    if (!geom || geom[0] < 1 || geom[0] > MAXD) return false;
    g.nd = (int)geom[0];
    for (int d = 0; d < MAXD; ++d) {
        g.size[d] = d < g.nd ? geom[1 + d] : 1;
        g.stride[d] = d < g.nd ? geom[1 + g.nd + d] : 0;
        if (g.size[d] < 1 || g.size[d] > 0x7fffffffll || g.stride[d] < 0) return false;
    }
    return true;
}

// an operand's rows can be read 16 bytes at a time: every row starts on a
// 16-byte boundary
bool vec_rows(const void* p, const Rows& g) {
    bool ok = aligned(p);
    for (int d = 0; d < g.nd; ++d) ok = ok && g.stride[d] % 4 == 0;
    return ok;
}

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

// x [n, nd] int32 (any sign, 1 <= nd <= 2L - 1), any contiguous view -> out
// [n, L] canonical, 16-byte aligned
int ring_reduce(int ring, const void* x, void* out, long long n, int nd, void* stream) {
    const int L = (ring == 0 || ring == 2) ? 32 : 16;
    if (n < 1 || nd < 1 || nd > 2 * L - 1 || n > 0x7fffffffll * THREADS || !aligned(out))
        return (int)cudaErrorInvalidValue;
    const bool vec = nd % 4 == 0 && aligned(x);
    const int s = (vec ? nd / 4 : nd) | 1;  // the tile's row stride in units
    const int smem = std::max(THREADS * s * (vec ? 16 : 4), THREADS * L);
#define CALL(R)                                                                        \
    ring_reduce_kernel<R><<<blocks(n), THREADS, smem, (cudaStream_t)stream>>>(         \
        (const int*)x, (int*)out, n, nd, vec)
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

// a, b canonical int32 rows read in place where ageom, bgeom (rows_of)
// put them; b may be null; out [n, L] 16-byte aligned, n < 2^31; |sa|,
// |sb| < 2^9
int ring_combine(int ring, const void* a, const long long* ageom, const void* b,
                 const long long* bgeom, void* out, long long n, int sa, int sb, void* stream) {
    Rows ag, bg;
    if (n < 1 || n > 0x7fffffffll || !aligned(out) || !rows_of(ageom, ag) ||
        (b && !rows_of(bgeom, bg)) || sa <= -512 || sa >= 512 || sb <= -512 || sb >= 512)
        return (int)cudaErrorInvalidValue;
    if (!b) bg = ag;
#define CALL(R)                                                                        \
    ring_combine_kernel<R><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(           \
        (const int*)a, (const int*)b, (int*)out, n, ag, bg, sa, sb, vec_rows(a, ag),     \
        vec_rows(b, bg))
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

// a canonical int32 [outer, k, inner, L], any contiguous view; out [outer,
// inner, L] (n = outer inner) 16-byte aligned; 1 <= k < 2^22
int ring_sum(int ring, const void* a, void* out, long long n, int k, long long inner,
             void* stream) {
    if (n < 1 || n > 0x7fffffffll * THREADS || k < 1 || k >= (1 << 22) || inner < 1 ||
        n % inner != 0 || !aligned(out))
        return (int)cudaErrorInvalidValue;
#define CALL(R)                                                                        \
    ring_sum_kernel<R><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(               \
        (const int*)a, (int*)out, n, k, inner, aligned(a))
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

// v [n] int32 -> out [n, L] canonical (v mod 2^32), 16-byte aligned
int ring_from_i32(int ring, const void* v, void* out, long long n, void* stream) {
    if (n < 1 || n > 0x7fffffffll * THREADS || !aligned(out)) return (int)cudaErrorInvalidValue;
#define CALL(R)                                                                        \
    ring_from_i32_kernel<R><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(          \
        (const int*)v, (int*)out, n)
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

// a, b canonical int32 rows read in place where ageom, bgeom (rows_of) put
// them; out [n, L] 16-byte aligned, n < 2^31
int ring_mul(int ring, const void* a, const long long* ageom, const void* b,
             const long long* bgeom, void* out, long long n, void* stream) {
    Rows ag, bg;
    if (n < 1 || n > 0x7fffffffll || !aligned(out) || !rows_of(ageom, ag) ||
        !rows_of(bgeom, bg))
        return (int)cudaErrorInvalidValue;
#define CALL(R)                                                                        \
    ring_mul_kernel<R><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(               \
        (const int*)a, (const int*)b, (int*)out, n, ag, bg, vec_rows(a, ag), vec_rows(b, bg))
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

// A [r, k, L], B [k, c, L], out [r, c, L] int32, canonical, 16-byte aligned;
// 1 <= k <= MATMUL_MAX_K
int ring_matmul(int ring, const void* A, const void* B, void* out, int r, int k, int c,
                void* stream) {
    const long long n = (long long)r * c;
    if (r < 1 || c < 1 || k < 1 || k > MATMUL_MAX_K || n > 0x7fffffffll * MM_WARPS ||
        !aligned(A) || !aligned(B) || !aligned(out))
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n + MM_WARPS - 1) / MM_WARPS);
#define CALL(R)                                                                        \
    ring_matmul_kernel<R><<<grid, MM_WARPS * 32, 0, (cudaStream_t)stream>>>(            \
        (const int*)A, (const int*)B, (int*)out, r, k, c)
    RING_SWITCH(ring, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

long long ring_matmul_max_k() { return MATMUL_MAX_K; }

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
