// Kernel K6: the centred CRT basis extension of protocol-bounded values.
//
// Replaces sfgwas_tpu/ops/rns.py::crt_lift_centered_dev (:540-582), the
// collective bootstrap's recode of the masked decryption from the l active
// primes to the target primes (Halevi-Polyakov-Shoup).  For each column m of
// x [l, M] (residues of one centred value v, |v| < Q/4, Q = q_0 ... q_{l-1}):
//   y_i = x_i * w_i mod q_i,              w_i = (Q/q_i)^-1 mod q_i
//   k   = round(sum_i y_i * (1/q_i))      in float32, as the reference does:
//                                          exact because |v| < Q/4 keeps the
//                                          sum a quarter away from a half
//   out[d] = sum_i y_i * T[d, i] + k * (p_d - Q mod p_d)  mod p_d,
//                                          T[d, i] = (Q/q_i) mod p_d
// for every destination prime p_d.  The result is the canonical residue, the
// one the reference's Barrett chain gives.
//
// What bounds it on the H100: bytes.  Per column it reads l words and
// writes D, and does a few integer operations per word written.
//
// The first design (one thread per column, a serial loop over all D rows,
// each step l + 4 loads of uniform table entries and a 64-bit Barrett step
// on a 64-bit sum) ran at 14% of its bound on the PN14 bootstrap's lifts, 3
// -> 9 and 3 -> 17 rows of 131,072 columns: 0.0135 and 0.0221 ms on the
// H100, 1.08 us a destination row.  Its instructions set that pace: the row
// loop's bound-checked unroll over LMAX source rows compiled to one body of
// 208 predicated instructions (cuobjdump), issued for every row whatever l,
// 3,737 a column at 3 -> 17 and about two thirds of the card's issue rate.
//
// This design:
//  * spreads the destination rows over the grid: blockIdx.y picks a group of
//    G rows (G <= GMAX, from the wrapper), blockIdx.x a tile of columns; each
//    group recomputes y and k for its columns, so x is read once per group
//    (from L2 after the first) and no thread loops over all D rows;
//  * stages the tables a block needs once, in shared memory: w_i, its Shoup
//    quotient, q_i and 1/q_i for the l source rows, and for each of its G
//    rows negQ_d, p_d, their constants and T[d, i] with their quotients
//    (one packed table, laid out below, copied whole);
//  * folds in 32 bits only: y_i by a Shoup multiply and a conditional
//    subtract; each term y_i T[d, i] and k negQ_d by a Shoup multiply into
//    [0, 2 p_d); their lazy sum of l + 1 terms (below 2 (l + 1) p_d < 2^32,
//    which the wrapper checks for the primes it is given) by one 32-bit
//    Barrett step and a conditional subtract;
//  * keeps k bit for bit: s = 0, s = s + (float)y_i * (1/q_i) in row order,
//    each step rounded (no fused multiply-add), then rintf;
//  * gives a thread VEC = 4 consecutive columns with 16-byte loads and
//    stores when M % 4 == 0 and both x and out are 16-byte aligned, else one
//    column (the same template with V = 1);
//  * is a template over l (1..LMAX), so y lives in registers.
// At l = 3 the row loop is 96 instructions for 4 columns, 24 a column and
// row, and a group's own work (staging, x, y, k) about 47 a column: 549 a
// column at 3 -> 17 in 3 groups.  G: of 1..8 at 3 -> 9 and 3 -> 17, the
// fastest were 5 and 6 (groups 5 + 4 and 6 + 6 + 5), G = 1 the slowest by
// 29% and 47%, so the wrapper takes the fewest groups of at most 6 rows, as
// even as they come (rns.crt_lift_group).  It runs 3 -> 17 in 0.0058 ms, 54% of
// its bound; about 2 us of that is the launch's fixed cost (3 -> 1 takes
// 0.0022 ms).

#include <cmath>

#include "common.cuh"

namespace {

constexpr int LMAX = 24;
constexpr int GMAX = 8;  // destination rows a block, at most
constexpr int THREADS = 128;
constexpr int VEC = 4;
// the packed table: SRC words per source row (w, ws, q, the bits of 1/q),
// then per destination row DST_HEAD words (negQ, negQs, p, m = floor(2^32 / p))
// and T[d, i], Ts[d, i] for each source row i
constexpr int SRC = 4;
constexpr int DST_HEAD = 4;

template <int V>
__device__ __forceinline__ void load_v(uint32_t (&v)[V], const uint32_t* __restrict__ p) {
    if constexpr (V == 4) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
        v[0] = u.x;
        v[1] = u.y;
        v[2] = u.z;
        v[3] = u.w;
    } else {
        v[0] = __ldg(p);
    }
}

// one 16-byte store (an assignment through a uint4 pointer compiled to four
// 4-byte stores in this kernel)
template <int V>
__device__ __forceinline__ void store_v(uint32_t* __restrict__ p, const uint32_t (&v)[V]) {
    if constexpr (V == 4)
        __stwb(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
    else
        *p = v[0];
}

template <int L, int V>
__global__ void __launch_bounds__(THREADS)
crt_lift_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ x,
                const uint32_t* __restrict__ tab, const int D, const int G, const size_t M) {
    constexpr int ROW = DST_HEAD + 2 * L;
    __shared__ uint32_t s_src[SRC * L];
    __shared__ uint32_t s_dst[GMAX * ROW];
    const int d0 = blockIdx.y * G;
    const int rows = min(G, D - d0);
    const uint32_t* dtab = tab + SRC * L + (size_t)d0 * ROW;
    for (int j = threadIdx.x; j < SRC * L; j += THREADS) s_src[j] = __ldg(tab + j);
    for (int j = threadIdx.x; j < rows * ROW; j += THREADS) s_dst[j] = __ldg(dtab + j);
    __syncthreads();
    const size_t m0 = ((size_t)blockIdx.x * THREADS + threadIdx.x) * V;
    if (m0 >= M) return;  // V = 4 only when M % 4 == 0: the whole vector is in

    uint32_t y[L][V];
    float s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = 0.0f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const uint32_t w = s_src[SRC * i], ws = s_src[SRC * i + 1], q = s_src[SRC * i + 2];
        const float inv_q = __uint_as_float(s_src[SRC * i + 3]);
        uint32_t xi[V];
        load_v<V>(xi, x + (size_t)i * M + m0);
#pragma unroll
        for (int v = 0; v < V; ++v) {
            y[i][v] = sub_if_ge(shoup_lazy(xi[v], w, ws, q), q);
            s[v] = __fadd_rn(s[v], __fmul_rn((float)y[i][v], inv_q));
        }
    }
    uint32_t k[V];
#pragma unroll
    for (int v = 0; v < V; ++v) k[v] = (uint32_t)rintf(s[v]);  // in [0, l]

    for (int g = 0; g < rows; ++g) {
        const uint32_t* r = s_dst + g * ROW;
        const uint32_t p = r[2], m = r[3];
        uint32_t acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = shoup_lazy(k[v], r[0], r[1], p);
#pragma unroll
        for (int i = 0; i < L; ++i) {
            const uint32_t t = r[DST_HEAD + 2 * i], ts = r[DST_HEAD + 2 * i + 1];
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] += shoup_lazy(y[i][v], t, ts, p);
        }
        uint32_t o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = sub_if_ge(barrett32_lazy(acc[v], m, p), p);
        store_v<V>(out + (size_t)(d0 + g) * M + m0, o);
    }
}

template <int L>
int launch(uint32_t* out, const uint32_t* x, const uint32_t* tab, int D, int G, size_t M,
           cudaStream_t st) {
    const bool vec = M % VEC == 0 && ((uintptr_t)out | (uintptr_t)x) % 16 == 0;
    const size_t blocks = ((vec ? M / VEC : M) + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks, (unsigned)((D + G - 1) / G));
    if (vec)
        crt_lift_kernel<L, VEC><<<grid, THREADS, 0, st>>>(out, x, tab, D, G, M);
    else
        crt_lift_kernel<L, 1><<<grid, THREADS, 0, st>>>(out, x, tab, D, G, M);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int crt_lift_max_rows() { return LMAX; }

int crt_lift_max_group() { return GMAX; }

// out [D, M], x [l, M] uint32; tab the packed table above, SRC l + D
// (DST_HEAD + 2 l) words; G destination rows a block
int crt_lift(void* out, const void* x, const void* tab, int l, int D, int G, long long M,
             void* stream) {
    if (l < 1 || l > LMAX || D < 1 || G < 1 || G > GMAX || M < 1 || (D + G - 1) / G > 65535)
        return (int)cudaErrorInvalidValue;
    uint32_t* o = (uint32_t*)out;
    const uint32_t* xx = (const uint32_t*)x;
    const uint32_t* t = (const uint32_t*)tab;
    const cudaStream_t st = (cudaStream_t)stream;
#define CRT_CASE(j) \
    case j:         \
        return launch<j>(o, xx, t, D, G, (size_t)M, st);
    switch (l) {
        CRT_CASE(1) CRT_CASE(2) CRT_CASE(3) CRT_CASE(4) CRT_CASE(5) CRT_CASE(6)
        CRT_CASE(7) CRT_CASE(8) CRT_CASE(9) CRT_CASE(10) CRT_CASE(11) CRT_CASE(12)
        CRT_CASE(13) CRT_CASE(14) CRT_CASE(15) CRT_CASE(16) CRT_CASE(17) CRT_CASE(18)
        CRT_CASE(19) CRT_CASE(20) CRT_CASE(21) CRT_CASE(22) CRT_CASE(23) CRT_CASE(24)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef CRT_CASE
}

}  // extern "C"
