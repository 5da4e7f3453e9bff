// Kernel K1: batched negacyclic NTT / inverse NTT over RNS residues.
//
// Replaces sfgwas_tpu/ops/pallas_ntt.py::ntt_pallas_b (_fwd_kernel_b,
// _inv_kernel_b) and ntt_pallas (_fwd_kernel, _inv_kernel; B = 1 here).
//
// x is [L, B, N] uint32 (< 2^26, stored by the caller as int32 with the same
// bits), one prime row per leading index.  Forward: Cooley-Tukey, standard
// order in, bit-reversed out, stage s pairing the coefficients that differ
// in bit logn-1-s with twiddle psi[2^s + (u >> (logn - s))].  Inverse:
// Gentleman-Sande over the same pairs in the opposite order, then the n^-1
// fold.  Twiddle products are Shoup multiplications (__umulhi on the
// precomputed companion); the output is the canonical residue, so it is
// bit-identical to rns._ntt_b_butterfly.
//
// Two floors on the H100.  Bytes: each poly is read and written once
// (8 bytes per coefficient), 1.07 ms at 3.35 TB/s for the grouped ModUp's
// [8, 3416, 2^14].  Integer instructions: 7 * 2^13 butterflies per stage and
// 14 stages per poly at PN14; at ~10 instructions a butterfly (a Shoup
// multiply is three, plus conditional subtracts) the integer pipe needs
// about as long as the bytes do, so the butterfly has to be short as well.
//
// The design.
//  - Registers between stages.  A thread holds RC = 32 coefficients, the 32
//    values of a window of R = 5 index bits, and runs up to five stages on
//    them in registers.  The log2 N stages take ceil(logn / 5) passes (three
//    at PN14: 5 + 5 + 4 stages) with one __syncthreads() between passes; the
//    poly crosses shared memory only between passes.  A pass reads and
//    writes back the same positions, so the exchange needs no second
//    buffer; one padding word per 32 makes every exchange free of bank
//    conflicts.  The first forward pass reads its 32 coefficients straight
//    from device memory at stride N/32 (coalesced across the warp).  The
//    last pass holds 32 contiguous outputs a thread; a warp writes its 1024
//    through its own part of shared memory as 16-byte stores, 512
//    contiguous bytes an instruction (a thread's own 16-byte stores, 128
//    bytes apart, would write half sectors).  The inverse runs the same
//    passes mirrored: 16-byte loads through shared memory first, coalesced
//    strided stores last, the n^-1 fold in its last pass.
//  - Twiddles.  In one stage a thread's butterflies need one contiguous,
//    aligned run of psi (2^(4-w) words for window bit w), so it reads them
//    as 16-byte loads, each twiddle once per pass: r - 1 = 31 pairs per
//    full pass.  In the first passes all threads of a warp share a run (a
//    broadcast); the rows' tables are shared by all polys of a row and stay
//    in L1/L2.
//  - Short butterflies.  Forward values are not reduced between stages:
//    the Shoup product lies in [0, 2q), x + t and x + 2q - t grow by at most
//    2q a stage, so after logn <= 15 stages every value is below 31q < 2^31
//    (every prime is below 2^26).  A forward butterfly is then 5 integer
//    instructions (umulhi, two multiply-adds, two adds); one Shoup step by
//    1 (companion floor(2^32/q)) and one conditional subtract make the
//    output canonical.  The inverse keeps Harvey's bound [0, 2q): x + y is
//    corrected with one min, the difference enters the Shoup product lazily.
//  - 256 threads a block: several polys per block at small N, masked when
//    B is not a multiple; one poly per block from N = 2^13, each thread
//    taking N / 8192 groups a pass.  Three blocks per SM at PN14 (80
//    registers a thread, so 32 coefficients and a pass's twiddles fit
//    without spilling; 66 KB of shared memory each).  The shared-memory
//    limit is raised once per device (smem_limit_once).

#include <utility>

#include "common.cuh"

namespace {

constexpr int R = 5;  // log2 of the coefficients a thread holds
constexpr int RC = 1 << R;
constexpr int THREADS = 256;  // a block: one poly from N = 2^13, several below
constexpr int SM_THREADS = 768;  // threads resident per SM: caps registers at 80
constexpr int SM_SMEM = 232448;  // shared memory of an SM that blocks can use

template <int LOGN>
struct Plan {
    static_assert(LOGN > R && LOGN <= 3 * R, "K1 runs 2 or 3 passes");
    static constexpr int N = 1 << LOGN;
    static constexpr int TPOLY = N / RC < THREADS ? N / RC : THREADS;  // threads per poly
    static constexpr int GROUPS = N / RC / TPOLY;  // 32-coefficient groups a thread takes per pass
    static constexpr int POLYS = THREADS / TPOLY;
    static constexpr int PADDED = N + N / 32;  // one padding word per 32
    static constexpr int NPASS = (LOGN + R - 1) / R;
    static constexpr int SMEM = POLYS * PADDED * 4;
    // blocks resident per SM, for __launch_bounds__: by threads, unless
    // shared memory holds fewer (N = 2^15: one, with registers to spare)
    static constexpr int BLOCKS = SM_THREADS / THREADS < SM_SMEM / SMEM ? SM_THREADS / THREADS
                                                                        : SM_SMEM / SMEM;
};

// forward pass P: stages S .. S+K-1 on the window of index bits LO .. LO+R-1
template <int LOGN, int P>
struct Pass {
    static constexpr int S = P * R;
    static constexpr int K = LOGN - S < R ? LOGN - S : R;
    static constexpr int LO = LOGN - S - R > 0 ? LOGN - S - R : 0;
};

// In a pass whose window starts at index bit LO, coefficient e of group gid
// is cbase(gid) + (e << LO) of the poly, and sbase(gid) + soff(e) of the
// shared poly, which holds index i at i + (i >> 5): a base per group and a
// constant per register, so the 32 addresses cost no registers.
template <int LO>
__device__ __forceinline__ int cbase(int gid) {
    return (gid & ((1 << LO) - 1)) + ((gid >> LO) << (LO + R));
}

template <int LO>
__device__ __forceinline__ int sbase(int gid) {
    const int low = gid & ((1 << LO) - 1), hi = gid >> LO;
    return low + (low >> 5) + (hi << (LO + R)) + (hi << (LO + R - 5));
}

template <int LO>
__device__ __forceinline__ constexpr int soff(int e) {
    if constexpr (LO >= 5)
        return (e << LO) + (e << (LO - 5));
    else
        return (e << LO) + (e >> (5 - LO));
}

template <int CH>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p, uint32_t (&v)[CH]) {
    if constexpr (CH == 4) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else if constexpr (CH == 2) {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
        v[0] = t.x, v[1] = t.y;
    } else {
        v[0] = __ldg(p);
    }
}

// forward stage S+I (INV: the inverse's stage on the same pairs) on the
// thread's registers: window bit W pairs e with e | 2^W; the butterflies
// with e >> (W+1) = j take twiddle base + j
template <int LOGN, int P, int I, bool INV>
__device__ __forceinline__ void stage(uint32_t (&a)[RC], int gid, const uint32_t* __restrict__ tw,
                                      const uint32_t* __restrict__ tws, uint32_t q) {
    using PS = Pass<LOGN, P>;
    constexpr int s = PS::S + I;
    constexpr int W = LOGN - 1 - s - PS::LO;
    static_assert(W >= 0 && W < R, "stage outside the window");
    constexpr int RUN = 1 << (R - 1 - W);
    constexpr int CH = RUN < 4 ? RUN : 4;
    const int base = (1 << s) + ((gid >> PS::LO) << (R - 1 - W));
    const uint32_t q2 = 2 * q;
#pragma unroll
    for (int j0 = 0; j0 < RUN; j0 += CH) {
        uint32_t w[CH], ws[CH];
        load_words<CH>(tw + base + j0, w);
        load_words<CH>(tws + base + j0, ws);
#pragma unroll
        for (int jj = 0; jj < CH; ++jj) {
#pragma unroll
            for (int xl = 0; xl < (1 << W); ++xl) {
                const int e = ((j0 + jj) << (W + 1)) | xl;
                uint32_t& u = a[e];
                uint32_t& v = a[e | (1 << W)];
                if constexpr (!INV) {  // values grow by < 2q a stage
                    const uint32_t t = shoup_lazy(v, w[jj], ws[jj], q);
                    v = u + q2 - t;
                    u = u + t;
                } else {  // values stay in [0, 2q)
                    const uint32_t sum = u + v;
                    const uint32_t d = u + q2 - v;
                    u = min(sum, sum - q2);
                    v = shoup_lazy(d, w[jj], ws[jj], q);
                }
            }
        }
    }
}

template <int LOGN, int P, bool INV, int... I>
__device__ __forceinline__ void stages(std::integer_sequence<int, I...>, uint32_t (&a)[RC], int gid,
                                       const uint32_t* __restrict__ tw,
                                       const uint32_t* __restrict__ tws, uint32_t q) {
    if constexpr (!INV)
        (stage<LOGN, P, I, false>(a, gid, tw, tws, q), ...);
    else
        (stage<LOGN, P, Pass<LOGN, P>::K - 1 - I, true>(a, gid, tw, tws, q), ...);
}

// The block's polys: shared copies and its first poly in x and y
struct Io {
    uint32_t* smem;
    const uint32_t* x;
    uint32_t* y;
    int nlive;  // polys of the block below B
};

// coefficients f .. f+3 (f flat over the block's polys, a multiple of 4) in
// the shared polys
template <int LOGN>
__device__ __forceinline__ uint32_t* shared_chunk(uint32_t* smem, int f) {
    const int c = f & ((1 << LOGN) - 1);
    return smem + (f >> LOGN) * Plan<LOGN>::PADDED + c + (c >> 5);
}

// One pass over the thread's groups: from device memory (first pass) or the
// shared poly, through the pass's stages, to the shared poly or device
// memory (last pass: the fold by fw and one conditional subtract).  Where a
// thread holds 32 contiguous coefficients (window at bit 0), a warp's 1024
// are contiguous in device memory; they pass through the warp's own part of
// the shared polys, so that each of its device accesses covers 512
// contiguous bytes, 16 a lane, and no sector is read or written in part.
template <int LOGN, int P, bool INV>
__device__ __forceinline__ void run_pass(const Io& io, const uint32_t* __restrict__ tw,
                                         const uint32_t* __restrict__ tws, uint32_t q, uint32_t fw,
                                         uint32_t fws) {
    using PL = Plan<LOGN>;
    using PS = Pass<LOGN, P>;
    constexpr bool FROM_DEVICE = INV ? P == PL::NPASS - 1 : P == 0;
    constexpr bool TO_DEVICE = INV ? P == 0 : P == PL::NPASS - 1;
    const int slot = threadIdx.x / PL::TPOLY;
    const int tp = threadIdx.x % PL::TPOLY;
    const bool live = slot < io.nlive;
    uint32_t* sh = io.smem + slot * PL::PADDED;
    const int lane = threadIdx.x & 31;
    const int first = threadIdx.x - lane;  // the warp's first thread
#pragma unroll 1
    for (int g = 0; g < PL::GROUPS; ++g) {
        const int gid = tp + g * PL::TPOLY;
        // this lane's first chunk of the warp's contiguous coefficients
        const int f0 =
            (first / PL::TPOLY) * PL::N + (first % PL::TPOLY + g * PL::TPOLY) * RC + lane * 4;
        uint32_t a[RC];
        if constexpr (FROM_DEVICE && PS::LO == 0) {
#pragma unroll
            for (int k = 0; k < RC / 4; ++k) {
                const int f = f0 + k * 128;
                const uint4 t = (f >> LOGN) < io.nlive
                                    ? __ldg(reinterpret_cast<const uint4*>(io.x + f))
                                    : make_uint4(0, 0, 0, 0);
                uint32_t* c = shared_chunk<LOGN>(io.smem, f);
                c[0] = t.x, c[1] = t.y, c[2] = t.z, c[3] = t.w;
            }
            __syncwarp();
        }
        if constexpr (FROM_DEVICE && PS::LO != 0) {
            const uint32_t* src = io.x + slot * PL::N + cbase<PS::LO>(gid);
#pragma unroll
            for (int e = 0; e < RC; ++e) a[e] = live ? __ldg(src + (e << PS::LO)) : 0;
        } else {
            const uint32_t* src = sh + sbase<PS::LO>(gid);
#pragma unroll
            for (int e = 0; e < RC; ++e) a[e] = src[soff<PS::LO>(e)];
        }
        stages<LOGN, P, INV>(std::make_integer_sequence<int, PS::K>{}, a, gid, tw, tws, q);
        if constexpr (TO_DEVICE) {
#pragma unroll
            for (int e = 0; e < RC; ++e) {
                const uint32_t r = shoup_lazy(a[e], fw, fws, q);
                a[e] = min(r, r - q);
            }
        }
        if constexpr (TO_DEVICE && PS::LO != 0) {
            if (live) {
                uint32_t* dst = io.y + slot * PL::N + cbase<PS::LO>(gid);
#pragma unroll
                for (int e = 0; e < RC; ++e) dst[e << PS::LO] = a[e];
            }
        } else {
            uint32_t* dst = sh + sbase<PS::LO>(gid);
#pragma unroll
            for (int e = 0; e < RC; ++e) dst[soff<PS::LO>(e)] = a[e];
        }
        if constexpr (TO_DEVICE && PS::LO == 0) {
            __syncwarp();
#pragma unroll
            for (int k = 0; k < RC / 4; ++k) {
                const int f = f0 + k * 128;
                const uint32_t* c = shared_chunk<LOGN>(io.smem, f);
                if ((f >> LOGN) < io.nlive)
                    *reinterpret_cast<uint4*>(io.y + f) = make_uint4(c[0], c[1], c[2], c[3]);
            }
        }
    }
}

// grid (ceil(B / POLYS), L); fold = ninv (inverse) or unused (forward: a
// Shoup step by 1 reduces the lazy outputs)
template <int LOGN, bool INV>
__global__ void __launch_bounds__(THREADS, Plan<LOGN>::BLOCKS)
ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
           const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws,
           const uint32_t* __restrict__ qv,
           const uint32_t* __restrict__ fold, const uint32_t* __restrict__ fold_s, int B) {
    using PL = Plan<LOGN>;
    extern __shared__ uint32_t smem[];
    const int row = blockIdx.y;
    const int b0 = blockIdx.x * PL::POLYS;
    const size_t off = ((size_t)row * B + b0) * PL::N;
    const Io io{smem, x + off, y + off, B - b0};
    tw += (size_t)row * PL::N;
    tws += (size_t)row * PL::N;
    const uint32_t q = qv[row];
    const uint32_t fw = INV ? fold[row] : 1u;
    const uint32_t fws = INV ? fold_s[row] : (uint32_t)((uint64_t(1) << 32) / q);
    constexpr int F = INV ? PL::NPASS - 1 : 0;  // first and last pass
    constexpr int T = INV ? 0 : PL::NPASS - 1;
    run_pass<LOGN, F, INV>(io, tw, tws, q, fw, fws);
    __syncthreads();
    if constexpr (PL::NPASS == 3) {
        run_pass<LOGN, 1, INV>(io, tw, tws, q, fw, fws);
        __syncthreads();
    }
    run_pass<LOGN, T, INV>(io, tw, tws, q, fw, fws);
}

template <int LOGN, bool INV>
int launch(const void* x, void* y, const void* tw, const void* tws, const void* q,
           const void* fold, const void* fold_s, int L, int B, cudaStream_t stream) {
    using PL = Plan<LOGN>;
    static std::atomic<uint64_t> attr_set{0};  // devices whose limit is raised
    const cudaError_t e = smem_limit_once(ntt_kernel<LOGN, INV>, PL::SMEM, attr_set);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((B + PL::POLYS - 1) / PL::POLYS), (unsigned)L);
    ntt_kernel<LOGN, INV><<<grid, THREADS, PL::SMEM, stream>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, (const uint32_t*)tws,
        (const uint32_t*)q, (const uint32_t*)fold, (const uint32_t*)fold_s, B);
    return (int)cudaGetLastError();
}

template <bool INV>
int dispatch(const void* x, void* y, const void* tw, const void* tws, const void* q,
             const void* fold, const void* fold_s, int L, int B, int logn, void* stream) {
    if (L < 1 || L > 65535 || B < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define NTT_CASE(n) \
    case n:         \
        return launch<n, INV>(x, y, tw, tws, q, fold, fold_s, L, B, st);
    switch (logn) {
        // the ring sizes of the presets
        NTT_CASE(8) NTT_CASE(10) NTT_CASE(12) NTT_CASE(13) NTT_CASE(14) NTT_CASE(15)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef NTT_CASE
}

}  // namespace

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int ntt_fwd(const void* x, void* y, const void* psi, const void* psi_s, const void* q,
            int L, int B, int logn, void* stream) {
    return dispatch<false>(x, y, psi, psi_s, q, nullptr, nullptr, L, B, logn, stream);
}

int ntt_inv(const void* x, void* y, const void* ipsi, const void* ipsi_s, const void* q,
            const void* ninv, const void* ninv_s, int L, int B, int logn, void* stream) {
    return dispatch<true>(x, y, ipsi, ipsi_s, q, ninv, ninv_s, L, B, logn, stream);
}

}  // extern "C"
