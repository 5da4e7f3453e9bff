// Kernel K4: uniform residues for the common reference polynomials.
//
// Replaces sfgwas_tpu/crypto/ckks.py::device_uniform_b (:1251-1268): two
// threefry words hi, lo per residue of a [batch, L, N] draw, at counters c
// and c + batch*L*N of jax.random.bits over the shape (2, batch, L, N), then
//   out = ((hi mod q) * (2^32 mod q) + (lo mod q)) mod q = (hi*2^32 + lo) mod q,
// reduced exactly with one 64-bit Barrett step (mu = floor(2^64 / q)).
//
// What bounds it on the H100: integer operations.  Each residue costs two
// Threefry-2x32 hashes (20 rounds of add, rotate, xor and five key
// injections, about 80 instructions each) and writes 4 bytes, so at the PN14
// rotation-key draw [56, 8, 2^14] the hashes (~1.2 G operations) take longer
// than the 29 MB write.  The design is the plain one: one thread per residue,
// the key derived once on the host (threefry.cuh), no shared memory; a warp
// writes 128 contiguous bytes.

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
uniform_mod_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ qv,
                   const uint64_t* __restrict__ muv, const TfKey key, const uint64_t total,
                   const int L, const int logn) {
    const uint64_t i = (uint64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= total) return;
    const int row = (int)((uint32_t)(i >> logn) % (uint32_t)L);
    const uint32_t hi = tf_bits(key, i);
    const uint32_t lo = tf_bits(key, i + total);
    out[i] = barrett64(((uint64_t)hi << 32) | lo, muv[row], qv[row]);
}

}  // namespace

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// out [batch, L, 2^logn] uint32; q [L] uint32 and mu [L] uint64 of the rows
int uniform_mod(void* out, const void* q, const void* mu, unsigned seed_lo, unsigned seed_hi,
                unsigned idx, int batch, int L, int logn, void* stream) {
    if (batch < 1 || L < 1 || logn < 1 || logn > 20) return (int)cudaErrorInvalidValue;
    const uint64_t total = (uint64_t)batch * L << logn;
    if ((total + THREADS - 1) / THREADS > 0x7fffffffu || (total >> logn) > 0xffffffffu)
        return (int)cudaErrorInvalidValue;
    const TfKey key = tf_derive_key(seed_lo, seed_hi, idx);
    uniform_mod_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)q,
                                                 (const uint64_t*)mu, key, total, L, logn);
    return (int)cudaGetLastError();
}

}  // extern "C"
