// Device helpers shared by the kernels K1-K6 (ntt.cu, mac_dense.cu,
// ks_digit.cu, crp.cu, bs_share.cu, crt_lift.cu).  Each source is built into
// a library of its own, so everything here has internal linkage.

#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// a mod q for a < 2^64, q < 2^32, mu = floor(2^64 / q): one umulhi and one
// conditional subtract
__device__ __forceinline__ uint32_t barrett64(uint64_t a, uint64_t mu, uint32_t q) {
    const uint64_t qhat = __umul64hi(a, mu);  // floor(a/q) - qhat is 0 or 1
    const uint32_t r = (uint32_t)a - (uint32_t)qhat * q;  // exact mod 2^32: r < 2q
    return r >= q ? r - q : r;
}

// 32-bit folds (K1, K4, K5), for q < 2^30.  m = floor(2^32 / q) is the
// high word of the Barrett constant floor(2^64 / q).

// a mod q up to one q, for any a < 2^32: the result is below 2q
__device__ __forceinline__ uint32_t barrett32_lazy(uint32_t a, uint32_t m, uint32_t q) {
    return a - __umulhi(a, m) * q;
}

// a * w mod q up to one q (Shoup), for any a < 2^32, w < q and
// ws = floor(w 2^32 / q): the result is below 2q
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w, uint32_t ws, uint32_t q) {
    return a * w - __umulhi(a, ws) * q;
}

// x mod q for x < 2q: x - q wraps above x when x < q
__device__ __forceinline__ uint32_t sub_if_ge(uint32_t x, uint32_t q) { return min(x, x - q); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device: `done` holds one bit per device already set
// (devices past 63 are set on every call).
template <typename Kernel>
cudaError_t smem_limit_once(Kernel* kernel, int bytes, std::atomic<uint64_t>& done) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
    if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return e;
}

}  // namespace
