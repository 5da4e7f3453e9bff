// Kernel K2: the dense BSGS multiply-accumulate of the encrypted genotype
// product.
//
// Replaces sfgwas_tpu/gwas/matmult.py:504 (_mac_scan_dense_b), a
// jax.lax.scan over giant-aligned chunks that gathers the hoisted baby
// rotations R[bidx], Barrett-multiplies them by the encoded diagonal polys
// P[idx], takes a lazy uint32 sum (split into nsub parts to stay exact),
// reduces, and adds into ACC[sg].
//
// What it computes.  The launch takes a CSR list of runs: run r owns the
// entries [run_start[r], run_start[r+1]), each a (diagonal, baby) pair, and
// one accumulator row run_sg[r].  For every row s, prime x, coefficient n:
//
//   ACC[run_sg[r], s, x, n] += sum_e R[entry_baby[e], s, x, n] * P[entry_diag[e], x, n]
//
// modulo q_x, for both ciphertext components (R0 -> ACC0, R1 -> ACC1).  Runs
// write distinct accumulator rows, so there are no write races.  There are
// no padding entries.  For one (x, n) this is a small dense product,
// ACC[runs x 2S] = P[runs x babies] . R[babies x 2S].
//
// What bounds it on the H100.  At the PN14 block row (62 runs, 5,545
// entries, 91 babies, 8 rows, nmod 7) the inputs are 2.5 GB of diagonal
// words and 0.67 GB of rotations: about 1 ms of HBM traffic.  The work is
// 10.2 G 32x32->64 multiply-adds on the integer pipe, of the same order.
// Every rotation word is used by every run (62 times), so a design that
// reads it from device memory per run moves 40 GB; the rotations (0.67 GB)
// do not fit the 50 MB L2.
//
// The design.  One block owns one prime x, one tile of 32 coefficients
// (one per lane) and SB rows (SB = 8 at PN14: all rows), and every run.  It
// first stages that tile of all the block row's baby rotations into shared
// memory with cp.async (nb * SB * 2 * 32 * 4 bytes: 182 KB at nb = 91,
// SB = 8; the dynamic-size attribute is set once per device).  Each of its
// 16 warps then walks whole runs: a lane reads each diagonal word of its
// run once from device memory (coalesced across the warp) and applies it to
// the 2*SB u64 accumulators of its (run, coefficient), taking the rotation
// words from shared memory.  So P is read once, R once and ACC once.  The
// diagonal words come in batches of 8 entries, double-buffered in
// registers: the next batch is in flight while the current one is applied,
// which hides the device-memory latency behind the multiply-adds (with one
// block of 16 warps per SM, a warp that waited on each batch left the
// loads exposed).  A u64 sum of up to 4096 products below 2^52 cannot
// overflow (the wrapper checks the longest run on the host); each output is
// reduced once with a Barrett step on the 64-bit sum (qhat = umulhi(a, mu),
// mu = floor(2^64 / q), one conditional subtract), no '%'.  S is split over
// blocks (grid z) in groups of SB rows, the largest divisor of S up to 8
// whose rotation tile fits in shared memory.  What is left at PN14 is the
// integer pipe (the wide multiply-adds) and the shared-memory reads of the
// rotations, each used once per run; int8 digit planes on the tensor cores
// would take the multiply-adds off the integer pipe.

#include "common.cuh"

namespace {

constexpr int TILE = 32;        // coefficients per block, one per lane
constexpr int WARPS = 16;       // warps per block; each walks whole runs
constexpr int DEPTH = 8;        // diagonal words a lane has in flight, per buffer
constexpr int MAX_SB = 8;       // rows per block
constexpr int MAX_SMEM = 232448;  // the H100's opt-in dynamic shared memory per block

// the diagonal words of entries [e, e + D) for this lane (0 past e_end,
// which adds nothing) and their babies
template <int D>
__device__ __forceinline__ void fetch(uint32_t (&p)[D], int (&b)[D], int e, int e_end,
                                      const int32_t* __restrict__ entry_diag,
                                      const int32_t* __restrict__ entry_baby,
                                      const uint32_t* __restrict__ pcol, size_t pstride) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
        const bool ok = e + i < e_end;
        const int d = ok ? entry_diag[e + i] : 0;
        b[i] = ok ? entry_baby[e + i] : 0;
        p[i] = ok ? pcol[(size_t)d * pstride] : 0u;
    }
}

template <int SB>
__global__ void __launch_bounds__(WARPS * 32, 1)
mac_dense_kernel(uint32_t* __restrict__ acc0, uint32_t* __restrict__ acc1,
                 const uint32_t* __restrict__ r0, const uint32_t* __restrict__ r1,
                 const uint32_t* __restrict__ polys,
                 const int32_t* __restrict__ entry_diag,
                 const int32_t* __restrict__ entry_baby,
                 const int32_t* __restrict__ run_start,
                 const int32_t* __restrict__ run_sg,
                 const uint32_t* __restrict__ qv, const uint64_t* __restrict__ muv,
                 int nruns, int nb, int S, int NM, int logn) {
    extern __shared__ __align__(16) uint32_t rs[];  // [nb][SB][2][TILE]
    const int n_ = 1 << logn;
    const int n0 = blockIdx.x * TILE;
    const int x = blockIdx.y;
    const int s0 = blockIdx.z * SB;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    // stage the tile of every baby rotation: nb*SB*2 segments of TILE words
    constexpr int PARTS = TILE / 4;  // 16-byte copies per segment
    const int ncopy = nb * SB * 2 * PARTS;
    for (int i = threadIdx.x; i < ncopy; i += blockDim.x) {
        const int seg = i / PARTS, part = i % PARTS;
        const int c = seg & 1, s = (seg >> 1) % SB, b = (seg >> 1) / SB;
        const uint32_t* src =
            (c ? r1 : r0) + (((size_t)b * S + s0 + s) * NM + x) * n_ + n0 + part * 4;
        cp_async16(rs + seg * TILE + part * 4, src);
    }
    cp_async_wait_all();
    __syncthreads();

    const uint32_t q = qv[x];
    const uint64_t mu = muv[x];
    const size_t pstride = (size_t)NM * n_;  // between diagonals
    const uint32_t* pcol = polys + (size_t)x * n_ + n0 + lane;
    const uint32_t* rl = rs + lane;

    for (int run = warp; run < nruns; run += WARPS) {
        uint64_t a0[SB], a1[SB];
#pragma unroll
        for (int s = 0; s < SB; ++s) a0[s] = a1[s] = 0;
        const int e_beg = run_start[run], e_end = run_start[run + 1];
        // double buffer: the next batch of diagonal words is in flight while
        // the current one is applied
        uint32_t pn[DEPTH];
        int bn[DEPTH];
        fetch<DEPTH>(pn, bn, e_beg, e_end, entry_diag, entry_baby, pcol, pstride);
        for (int e = e_beg; e < e_end; e += DEPTH) {
            uint32_t p[DEPTH];
            int bb[DEPTH];
#pragma unroll
            for (int i = 0; i < DEPTH; ++i) {
                p[i] = pn[i];
                bb[i] = bn[i];
            }
            if (e + DEPTH < e_end)
                fetch<DEPTH>(pn, bn, e + DEPTH, e_end, entry_diag, entry_baby, pcol, pstride);
#pragma unroll
            for (int i = 0; i < DEPTH; ++i) {
                const uint32_t* rb = rl + bb[i] * (SB * 2 * TILE);
#pragma unroll
                for (int s = 0; s < SB; ++s) {
                    a0[s] += (uint64_t)p[i] * rb[(2 * s) * TILE];
                    a1[s] += (uint64_t)p[i] * rb[(2 * s + 1) * TILE];
                }
            }
        }
        const int sg = run_sg[run];
#pragma unroll
        for (int s = 0; s < SB; ++s) {
            const size_t o = (((size_t)sg * S + s0 + s) * NM + x) * n_ + n0 + lane;
            const uint32_t v0 = acc0[o] + barrett64(a0[s], mu, q);
            const uint32_t v1 = acc1[o] + barrett64(a1[s], mu, q);
            acc0[o] = v0 >= q ? v0 - q : v0;
            acc1[o] = v1 >= q ? v1 - q : v1;
        }
    }
}

template <int SB>
int launch(void* acc0, void* acc1, const void* r0, const void* r1, const void* polys,
           const void* entry_diag, const void* entry_baby, const void* run_start,
           const void* run_sg, const void* q, const void* mu, int nruns, int nb, int S,
           int NM, int logn, cudaStream_t stream) {
    static std::atomic<uint64_t> attr_set{0};  // devices whose limit is raised
    const cudaError_t e = smem_limit_once(mac_dense_kernel<SB>, MAX_SMEM, attr_set);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = (size_t)nb * SB * 2 * TILE * 4;
    const dim3 grid((unsigned)((1 << logn) / TILE), (unsigned)NM, (unsigned)(S / SB));
    mac_dense_kernel<SB><<<grid, WARPS * 32, smem, stream>>>(
        (uint32_t*)acc0, (uint32_t*)acc1, (const uint32_t*)r0, (const uint32_t*)r1,
        (const uint32_t*)polys, (const int32_t*)entry_diag, (const int32_t*)entry_baby,
        (const int32_t*)run_start, (const int32_t*)run_sg, (const uint32_t*)q,
        (const uint64_t*)mu, nruns, nb, S, NM, logn);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// rows per block for S rows and nb babies: the largest divisor of S up to
// MAX_SB whose rotation tile fits in shared memory, or 0 if none does
int mac_dense_rows_per_block(int S, int nb) {
    for (int sb = S < MAX_SB ? S : MAX_SB; sb >= 1; --sb)
        if (S % sb == 0 && (size_t)nb * sb * 2 * TILE * 4 <= (size_t)MAX_SMEM) return sb;
    return 0;
}

int mac_dense(void* acc0, void* acc1, const void* r0, const void* r1, const void* polys,
              const void* entry_diag, const void* entry_baby, const void* run_start,
              const void* run_sg, const void* q, const void* mu, int nruns, int nb, int S,
              int NM, int logn, void* stream) {
    if (logn < 5 || nb < 1 || nruns < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define MAC_CASE(sb)                                                                     \
    case sb:                                                                             \
        return launch<sb>(acc0, acc1, r0, r1, polys, entry_diag, entry_baby, run_start, \
                          run_sg, q, mu, nruns, nb, S, NM, logn, st);
    switch (mac_dense_rows_per_block(S, nb)) {
        MAC_CASE(1)
        MAC_CASE(2)
        MAC_CASE(3)
        MAC_CASE(4)
        MAC_CASE(5)
        MAC_CASE(6)
        MAC_CASE(7)
        MAC_CASE(8)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef MAC_CASE
}

}  // extern "C"
