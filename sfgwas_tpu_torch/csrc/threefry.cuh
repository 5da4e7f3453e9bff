// Threefry-2x32 exactly as jax.random computes it (jax 0.9 with
// jax_threefry_partitionable on): the shared hash of the kernels K4 (crp.cu)
// and K5 (bs_share.cu).  Its plain version is sfgwas_tpu_torch/ops/threefry.py.
//
//   PRNGKey(s) = (0, s);  fold_in(key, d) = threefry2x32(key, (0, d));
//   bits(key, shape)[c] = y0 ^ y1 of threefry2x32(key, (c >> 32, c & mask))
//   for the flattened index c of the shape.
//
// Everything here has internal linkage; the key derivation is also host
// code, so a launcher derives the key once and hands it to its kernel.
//
// tf_bits_v is the kernels' form of the hash: V independent counters per
// thread, hashed round by round together, so that V dependency chains are in
// flight at once and the key schedule is read once.  A round is an add, a
// rotate and a xor: the rotate (SHF) and the xor (LOP3) run on the integer
// ALU pipe, and ptxas already issues most adds as IMAD on the FMA pipe
// beside them.  Forcing every add onto IMAD (a multiply-add by a kernel
// argument of 1) was measured and gained nothing (PERF.md).

#pragma once

#include <cstdint>

namespace {

struct TfKey {
    uint32_t k0, k1;
};

__host__ __device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// 20 rounds: five groups of four, the rotation constants of jax's
// threefry2x32_p, a key injection after each group
__host__ __device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                                     uint32_t& x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = tf_rotl(x1, rot[i & 1][j]);
            x1 ^= x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
}

// fold_in(fold_in(PRNGKey(seed_lo), seed_hi), idx): the key of every draw
// of the reference's device_uniform_b and _bs_share_kernel
__host__ __device__ inline TfKey tf_derive_key(uint32_t seed_lo, uint32_t seed_hi, uint32_t idx) {
    uint32_t a = 0, b = seed_hi;
    threefry2x32(0u, seed_lo, a, b);
    uint32_t c = 0, d = idx;
    threefry2x32(a, b, c, d);
    return TfKey{c, d};
}

// word c of jax.random.bits(key, shape, uint32) over the flattened shape
__device__ __forceinline__ uint32_t tf_bits(TfKey key, uint64_t c) {
    uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
    threefry2x32(key.k0, key.k1, x0, x1);
    return x0 ^ x1;
}

// V words of jax.random.bits at once: on entry (x0[v], x1[v]) are the high
// and low halves of counter v, on return x0[v] is its word
template <int V>
__device__ __forceinline__ void tf_bits_v(const TfKey key, uint32_t (&x0)[V], uint32_t (&x1)[V]) {
    const uint32_t ks[3] = {key.k0, key.k1, key.k0 ^ key.k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
    for (int v = 0; v < V; ++v) {
        x0[v] += ks[0];
        x1[v] += ks[1];
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
                x0[v] += x1[v];
                x1[v] = __funnelshift_l(x1[v], x1[v], rot[i & 1][j]) ^ x0[v];
            }
        }
        const uint32_t a = ks[(i + 1) % 3], b = ks[(i + 2) % 3] + (uint32_t)(i + 1);
#pragma unroll
        for (int v = 0; v < V; ++v) {
            x0[v] += a;
            x1[v] += b;
        }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) x0[v] ^= x1[v];
}

}  // namespace
