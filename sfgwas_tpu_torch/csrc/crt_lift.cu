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
// for every destination prime p_d.  The sum is exact in 64 bits (at most
// LMAX + 1 terms below 2^52) and reduced once with a Barrett step; the
// result is the canonical residue the reference's Barrett chain gives.
//
// What bounds it on the H100: bytes.  Per column it reads l words and
// writes D, and does about 2 l + 2 l D integer operations; at the PN14
// bootstrap (l = 3, D = 9 or 17) that is a few operations per byte.  The
// design: one thread per column, y held in registers (l <= LMAX, loops
// unrolled over LMAX with a bound check), the tables in constant-sized
// device arrays read through the read-only cache.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int LMAX = 24;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
crt_lift_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ x,
                const uint32_t* __restrict__ w, const uint32_t* __restrict__ q,
                const uint64_t* __restrict__ mu, const float* __restrict__ inv_q,
                const uint32_t* __restrict__ T, const uint32_t* __restrict__ negQ,
                const uint32_t* __restrict__ p, const uint64_t* __restrict__ mu_p, const int l,
                const int D, const size_t M) {
    const size_t m = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (m >= M) return;
    uint32_t y[LMAX];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < LMAX; ++i) {
        if (i < l) {
            y[i] = barrett64((uint64_t)x[(size_t)i * M + m] * __ldg(w + i), __ldg(mu + i), __ldg(q + i));
            s = __fadd_rn(s, __fmul_rn((float)y[i], __ldg(inv_q + i)));
        }
    }
    const uint32_t k = (uint32_t)rintf(s);  // in [0, l]
    for (int d = 0; d < D; ++d) {
        const uint32_t* t = T + (size_t)d * l;
        uint64_t acc = (uint64_t)k * __ldg(negQ + d);
#pragma unroll
        for (int i = 0; i < LMAX; ++i)
            if (i < l) acc += (uint64_t)y[i] * __ldg(t + i);
        out[(size_t)d * M + m] = barrett64(acc, __ldg(mu_p + d), __ldg(p + d));
    }
}

}  // namespace

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int crt_lift_max_rows() { return LMAX; }

// out [D, M], x [l, M] uint32; per source row w, q (uint32), mu (uint64),
// inv_q (float32); T [D, l], negQ [D] = p - (Q mod p), p [D] (uint32),
// mu_p [D] (uint64)
int crt_lift(void* out, const void* x, const void* w, const void* q, const void* mu,
             const void* inv_q, const void* T, const void* negQ, const void* p,
             const void* mu_p, int l, int D, long long M, void* stream) {
    if (l < 1 || l > LMAX || D < 1 || M < 1) return (int)cudaErrorInvalidValue;
    if (((size_t)M + THREADS - 1) / THREADS > 0x7fffffffu) return (int)cudaErrorInvalidValue;
    crt_lift_kernel<<<(unsigned)(((size_t)M + THREADS - 1) / THREADS), THREADS, 0,
                      (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)x, (const uint32_t*)w, (const uint32_t*)q,
        (const uint64_t*)mu, (const float*)inv_q, (const uint32_t*)T, (const uint32_t*)negQ,
        (const uint32_t*)p, (const uint64_t*)mu_p, l, D, (size_t)M);
    return (int)cudaGetLastError();
}

}  // extern "C"
