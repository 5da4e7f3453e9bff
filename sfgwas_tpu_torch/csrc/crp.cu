// Kernel K4: uniform residues for the common reference polynomials.
//
// Replaces sfgwas_tpu/crypto/ckks.py::device_uniform_b (:1251-1268): two
// threefry words hi, lo per residue of a [batch, L, N] draw, at counters c
// and c + batch*L*N of jax.random.bits over the shape (2, batch, L, N), then
//   out = ((hi mod q) * (2^32 mod q) + (lo mod q)) mod q = (hi*2^32 + lo) mod q.
//
// What bounds it on the H100: issued integer instructions.  Each residue
// costs two Threefry-2x32 hashes (20 rounds of add, rotate and xor and five
// key injections: 73 instructions a word) and writes 4 bytes, so at the PN14
// rotation-key draw [56, 8, 2^14] the hashes take longer than the 29 MB
// write.  The first design (one thread per residue, the row found by a
// 32-bit modulo, 64-bit counters, a 64-bit Barrett step) compiled to 191
// SASS instructions a residue (cuobjdump), against the 2 x 73 + 6 that the
// bound counts.  This design's row loop is 636 instructions for 4 residues,
// 159 a residue; its rotates and xors (SHF, LOP3: 82 a residue) on the ALU
// pipe now set its pace, the adds being mostly IMAD on the FMA pipe:
//  * a block's (b, row) pair is its grid y index, so the prime and its
//    constants are the block's, read once;
//  * the counter of coefficient n in draw row `row` is row*N + n (+ the
//    draw's size for lo).  N is a power of two that divides 2^32 and the
//    block's base row*N is a multiple of N, so adding n < N never carries out
//    of the low word: the high word is the block's and the low word one
//    32-bit add, for every draw size up to 2^63;
//  * a thread hashes 4 consecutive coefficients (8 words) together and
//    writes them with one 16-byte store;
//  * the fold is 32-bit: with m = floor(2^32/q), c = 2^32 mod q and its
//    Shoup quotient cs, all three read off the 64-bit Barrett constant
//    mu = floor(2^64/q) (m its high word, cs its low word, c = -m*q mod 2^32),
//      t = hi*c - umulhi(hi, cs)*q < 2q,  l = lo - umulhi(lo, m)*q < 2q,
//      s = t + l < 4q,  s - umulhi(s, m)*q < 2q,  one conditional subtract,
//    the same exact residue as the 64-bit step, for q < 2^30.

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int VEC = 4;  // coefficients a thread

__global__ void __launch_bounds__(THREADS)
uniform_mod_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ qv,
                   const uint64_t* __restrict__ muv, const TfKey key, const uint64_t total,
                   const int rows, const int L, const int logn) {
    const uint32_t n0 = (blockIdx.x * THREADS + threadIdx.x) * VEC;
    if (n0 >> logn) return;
    for (int row = blockIdx.y; row < rows; row += gridDim.y) {
        const int r = row % L;
        const uint32_t q = __ldg(qv + r);
        const uint64_t mu = __ldg(muv + r);
        const uint32_t m = (uint32_t)(mu >> 32), cs = (uint32_t)mu, c = 0u - m * q;
        const uint64_t hi = (uint64_t)row << logn, lo = hi + total;
        uint32_t x0[2 * VEC], x1[2 * VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
            x0[v] = (uint32_t)(hi >> 32);
            x1[v] = (uint32_t)hi + n0 + v;
            x0[VEC + v] = (uint32_t)(lo >> 32);
            x1[VEC + v] = (uint32_t)lo + n0 + v;
        }
        tf_bits_v(key, x0, x1);
        uint32_t o[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
            const uint32_t s = shoup_lazy(x0[v], c, cs, q) + barrett32_lazy(x0[VEC + v], m, q);
            o[v] = sub_if_ge(barrett32_lazy(s, m, q), q);
        }
        *reinterpret_cast<uint4*>(out + hi + n0) = make_uint4(o[0], o[1], o[2], o[3]);
    }
}

}  // namespace

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// out [batch, L, 2^logn] uint32 (16-byte aligned); q [L] uint32 (< 2^30) and
// mu [L] uint64 of the rows
int uniform_mod(void* out, const void* q, const void* mu, unsigned seed_lo, unsigned seed_hi,
                unsigned idx, int batch, int L, int logn, void* stream) {
    if (batch < 1 || L < 1 || logn < 2 || logn > 20 || (uint64_t)batch * L > 0x7fffffffu ||
        (uintptr_t)out % 16)
        return (int)cudaErrorInvalidValue;
    const int rows = batch * L;
    const uint64_t total = (uint64_t)rows << logn;
    const TfKey key = tf_derive_key(seed_lo, seed_hi, idx);
    const dim3 grid((unsigned)(((1u << logn) + THREADS * VEC - 1) / (THREADS * VEC)),
                    (unsigned)(rows < 65535 ? rows : 65535));
    uniform_mod_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)q, (const uint64_t*)mu, key, total, rows, L, logn);
    return (int)cudaGetLastError();
}

}  // extern "C"
