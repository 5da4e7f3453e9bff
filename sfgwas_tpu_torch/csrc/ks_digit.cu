// Kernel K3: the digit contraction of the hybrid keyswitch.
//
// Replaces the digit scans of sfgwas_tpu/crypto/ckks.py
// (_hoisted_rotations_all_body :993-1005 and _rotate_grouped_b_body
// :1050-1062): a jax.lax.scan over the digit axis j that accumulates
// Barrett products into lazy uint32 sums, followed by _reduce_u32.
//
//   out0[g,s,b,x,:] = sum_j ext[g,s,j,x,:] * key0[g,b,j,x,:]  mod q_x
//   out1[g,s,b,x,:] = sum_j ext[g,s,j,x,:] * key1[g,b,j,x,:]  mod q_x
//
// ext [G, S, J, X, N] is the NTT-domain ModUp of S ciphertexts per group,
// key* [G, Bk, J, X, N] the (inverse-permuted) switching keys; outputs are
// [G, S, Bk, X, N] canonical residues.  Hoisted rotations use G = 1 (every
// row times every baby key), grouped giant rotations Bk = 1 (one key per
// group).  All values are uint32 < 2^26.
//
// What bounds it on the H100: bytes.  At PN14 (J 7, X 8, S 8) the hoisted
// shape (G 1, Bk 90) moves 1.44 GB (keys and outputs; ext is 29 MB), the
// grouped shape (G 61, Bk 1) 2.75 GB (ext is the stream); the arithmetic,
// 2*J multiply-adds per output pair, is a few tenths of a millisecond on the
// integer pipe.  To run at that bound the kernel needs many loads in flight
// per SM, so registers per thread must stay low, and it must not spend the
// time of a 64-bit division per output.
//
// The design.  The digit count J is a template parameter (instances
// 1..KMAX, chosen by a switch), so a thread holds exactly J key words per
// coefficient and nothing is reserved for digits that do not exist.  A block
// owns one (g, x, tile of 128 coefficients); its 8 warps cover the tile
// with 4 coefficients per lane, so every device access is 16 bytes a lane.
// The block stages its tile of ext for its rows (rows * J * 512 bytes) into
// shared memory with cp.async, once.  Its warps then take work items (key b,
// group of rows): a lane loads the J key words of one component for its 4
// coefficients into registers (16-byte loads), walks the item's rows reading
// ext from shared memory, and writes each row's 4 outputs with one 16-byte
// store; then the other component.  Hoisted (Bk 90): an item is one key
// and all 8 rows, so a key word is read once and used 8 times, and ext,
// which fits in L2, is read once per block.  Grouped (Bk 1): an item is one
// row, so the 8 warps share the block's key (from L1) and ext streams
// through shared memory once.  Each output is reduced once with a Barrett
// step on its 64-bit sum (qhat = umulhi(a, mu), mu = floor(2^64 / q), one
// conditional subtract), no '%'.  Keys are split over blocks in chunks of
// 16 so that the hoisted shape fills the card.

#include "common.cuh"

#define KMAX 24

namespace {

constexpr int TILE = 128;  // coefficients per block: 4 per lane
constexpr int VEC = TILE / 4;  // uint4 per tile row
constexpr int WARPS = 8;
constexpr int KEYS_PER_BLOCK = 16;
constexpr int SMEM_BUDGET = 64 * 1024;  // ext staging per block (rows are split to fit)

struct Shape {
    int S, Bk, X, logn;
    int sc, nsc;   // rows per block, row chunks
    int nkc;       // key chunks (KEYS_PER_BLOCK keys each)
    int rpi;       // rows per work item
};

template <int J>
__global__ void __launch_bounds__(WARPS * 32)
ks_digit_kernel(const uint32_t* __restrict__ ext, const uint32_t* __restrict__ key0,
                const uint32_t* __restrict__ key1, uint32_t* __restrict__ out0,
                uint32_t* __restrict__ out1, const uint32_t* __restrict__ qv,
                const uint64_t* __restrict__ muv, const Shape sh) {
    extern __shared__ __align__(16) uint4 es[];  // [rows][J][VEC]
    const int n_ = 1 << sh.logn;
    const int ntiles = n_ / TILE;
    const int n0 = (blockIdx.x % ntiles) * TILE;
    const int x = blockIdx.y;
    int z = blockIdx.x / ntiles;
    const int kchunk = z % sh.nkc;
    z /= sh.nkc;
    const int schunk = z % sh.nsc;
    const int g = z / sh.nsc;
    const int s0 = schunk * sh.sc, s1 = min(sh.S, s0 + sh.sc);
    const int b0 = kchunk * KEYS_PER_BLOCK, b1 = min(sh.Bk, b0 + KEYS_PER_BLOCK);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const size_t jstride = (size_t)sh.X * n_;
    const size_t xoff = (size_t)x * n_ + n0;

    // stage ext[g, s0:s1, :, x, tile]: row r = (s - s0) * J + j
    const int ncopy = (s1 - s0) * J * VEC;
    const uint32_t* ebase = ext + ((size_t)g * sh.S + s0) * J * jstride + xoff;
    for (int i = threadIdx.x; i < ncopy; i += blockDim.x)
        cp_async16(es + i, ebase + (size_t)(i / VEC) * jstride + (i % VEC) * 4);
    cp_async_wait_all();
    __syncthreads();

    const uint32_t q = qv[x];
    const uint64_t mu = muv[x];
    const int ngrp = (s1 - s0 + sh.rpi - 1) / sh.rpi;
    const int items = (b1 - b0) * ngrp;
    for (int it = warp; it < items; it += WARPS) {
        const int b = b0 + it / ngrp;
        const int sa = s0 + (it % ngrp) * sh.rpi;
        const int sb = min(s1, sa + sh.rpi);
        const size_t kbase = ((size_t)g * sh.Bk + b) * J * jstride + xoff + lane * 4;
#pragma unroll 1
        for (int c = 0; c < 2; ++c) {
            const uint32_t* key = c ? key1 : key0;
            uint32_t* out = c ? out1 : out0;
            uint4 k[J];
#pragma unroll
            for (int j = 0; j < J; ++j)
                k[j] = __ldg(reinterpret_cast<const uint4*>(key + kbase + j * jstride));
            for (int s = sa; s < sb; ++s) {
                const uint4* e = es + (size_t)(s - s0) * J * VEC + lane;
                uint64_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
                for (int j = 0; j < J; ++j) {
                    const uint4 v = e[j * VEC];
                    a0 += (uint64_t)v.x * k[j].x;
                    a1 += (uint64_t)v.y * k[j].y;
                    a2 += (uint64_t)v.z * k[j].z;
                    a3 += (uint64_t)v.w * k[j].w;
                }
                uint4 r;
                r.x = barrett64(a0, mu, q);
                r.y = barrett64(a1, mu, q);
                r.z = barrett64(a2, mu, q);
                r.w = barrett64(a3, mu, q);
                const size_t o = ((((size_t)g * sh.S + s) * sh.Bk + b) * sh.X) * n_ + xoff + lane * 4;
                *reinterpret_cast<uint4*>(out + o) = r;
            }
        }
    }
}

template <int J>
int launch(const void* ext, const void* key0, const void* key1, void* out0, void* out1,
           const void* q, const void* mu, int G, const Shape& sh, cudaStream_t stream) {
    const size_t smem = (size_t)sh.sc * J * TILE * 4;
    static std::atomic<uint64_t> attr_set{0};  // devices whose limit is raised
    const cudaError_t e = smem_limit_once(ks_digit_kernel<J>, SMEM_BUDGET, attr_set);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(((size_t)1 << sh.logn) / TILE * G * sh.nsc * sh.nkc),
                    (unsigned)sh.X);
    ks_digit_kernel<J><<<grid, WARPS * 32, smem, stream>>>(
        (const uint32_t*)ext, (const uint32_t*)key0, (const uint32_t*)key1, (uint32_t*)out0,
        (uint32_t*)out1, (const uint32_t*)q, (const uint64_t*)mu, sh);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int ks_digit_max_digits() { return KMAX; }

int ks_digit_product(const void* ext, const void* key0, const void* key1, void* out0,
                     void* out1, const void* q, const void* mu, int G, int S, int Bk, int J,
                     int X, int logn, void* stream) {
    if (J < 1 || J > KMAX || logn < 7 || G < 1 || S < 1 || Bk < 1 || X < 1)
        return (int)cudaErrorInvalidValue;
    Shape sh;
    sh.S = S;
    sh.Bk = Bk;
    sh.X = X;
    sh.logn = logn;
    const int fit = SMEM_BUDGET / (J * TILE * 4);  // >= 5 rows for J <= KMAX
    sh.sc = S < fit ? S : fit;
    sh.nsc = (S + sh.sc - 1) / sh.sc;
    sh.nkc = (Bk + KEYS_PER_BLOCK - 1) / KEYS_PER_BLOCK;
    // enough items for the 8 warps: whole row chunks when there are keys
    // to spare, else fewer rows per item
    const int kb = Bk < KEYS_PER_BLOCK ? Bk : KEYS_PER_BLOCK;
    const int rpi = sh.sc * kb / WARPS;
    sh.rpi = rpi < 1 ? 1 : (rpi > sh.sc ? sh.sc : rpi);
    if (((size_t)1 << logn) / TILE * G * sh.nsc * sh.nkc > 0x7fffffffu || X > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define KS_CASE(j) \
    case j:        \
        return launch<j>(ext, key0, key1, out0, out1, q, mu, G, sh, st);
    switch (J) {
        KS_CASE(1) KS_CASE(2) KS_CASE(3) KS_CASE(4) KS_CASE(5) KS_CASE(6)
        KS_CASE(7) KS_CASE(8) KS_CASE(9) KS_CASE(10) KS_CASE(11) KS_CASE(12)
        KS_CASE(13) KS_CASE(14) KS_CASE(15) KS_CASE(16) KS_CASE(17) KS_CASE(18)
        KS_CASE(19) KS_CASE(20) KS_CASE(21) KS_CASE(22) KS_CASE(23) KS_CASE(24)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef KS_CASE
}

}  // extern "C"
