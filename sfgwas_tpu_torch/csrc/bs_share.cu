// Kernel K5: a party's share of the collective bootstrap, in two launches
// with kernel K1 (the forward NTT of the masks) between them.
//
// Replaces sfgwas_tpu/mpc/mhe.py::_bs_share_kernel (:589-648), which jax
// fuses into one XLA program.
//
// bs_mask (:601-628 before the NTT): the decryption mask.  For every
// (b, coefficient) it draws the nwords threefry words of
// jax.random.bits(key, (nwords, B, N)) (word k at counter (k*B + b)*N + n),
// keeps 24 bits of each, masks the top word to top_bits and centres it
// (subtracts 2^(top_bits-1)), so the mask is the signed integer
//   v = sum_k w_k 2^(24k),  |v| < 2^(24(nwords-1) + top_bits - 1).
// It writes v mod q for every row of `rows` ([L, B, N]) and of `tgt_rows`
// ([Lf, B, N]) in the coefficient domain: sum_k w_k (2^(24k) mod q) with the
// negative top word taken as w + q, summed exactly in 64 bits (each term
// < 2^50) and reduced once with a Barrett step.
//
// bs_combine (:630-647): with the masks in the NTT domain,
//   h1[b, r] = c1[b, r] * s[rows[r]] + e1[r, b] + mask_l[r, b]          mod q_r
//   h2[b, r] = -crp[b, r] * s[tgt_rows[r]] + e2[r, b] - mask_f[r, b]    mod q_r
// in one pass over both outputs.
//
// What bounds them on the H100: bs_mask by its hashes (nwords Threefry-2x32
// calls of about 80 integer instructions per coefficient against
// 4 (L + Lf) written bytes), bs_combine by bytes (it reads 4 and writes one
// residue per output).  The design is the plain one: one thread per
// (b, coefficient) in bs_mask, whose words sit in shared memory (each thread
// reads only its own), and one thread per output residue in bs_combine.

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int MASK_THREADS = 128;
constexpr int MAX_WORDS = 96;  // 96 * 128 * 4 = 48 KB of shared memory, no opt-in
constexpr int THREADS = 256;

__device__ __forceinline__ void fold_rows(uint32_t* __restrict__ out,
                                          const uint32_t* __restrict__ pw,
                                          const uint32_t* __restrict__ qv,
                                          const uint64_t* __restrict__ muv, const int* w,
                                          int nwords, int rows, size_t row_stride) {
    for (int r = 0; r < rows; ++r) {
        const uint32_t q = qv[r];
        const uint32_t* p = pw + (size_t)r * nwords;
        uint64_t acc = 0;
        for (int k = 0; k < nwords - 1; ++k)
            acc += (uint64_t)(uint32_t)w[k * MASK_THREADS] * __ldg(p + k);
        const int top = w[(nwords - 1) * MASK_THREADS];
        acc += (uint64_t)(top < 0 ? (uint32_t)(top + (int)q) : (uint32_t)top) * __ldg(p + nwords - 1);
        out[r * row_stride] = barrett64(acc, muv[r], q);
    }
}

__global__ void __launch_bounds__(MASK_THREADS)
bs_mask_kernel(uint32_t* __restrict__ out_l, uint32_t* __restrict__ out_f,
               const uint32_t* __restrict__ pw_l, const uint32_t* __restrict__ pw_f,
               const uint32_t* __restrict__ q_l, const uint32_t* __restrict__ q_f,
               const uint64_t* __restrict__ mu_l, const uint64_t* __restrict__ mu_f,
               const TfKey key, const int B, const int nwords, const int top_bits, const int L,
               const int Lf, const int logn) {
    extern __shared__ int ws[];  // [nwords][MASK_THREADS]
    const size_t cols = (size_t)B << logn;
    const size_t t = (size_t)blockIdx.x * MASK_THREADS + threadIdx.x;
    if (t >= cols) return;
    int* w = ws + threadIdx.x;
    for (int k = 0; k < nwords; ++k)
        w[k * MASK_THREADS] = (int)(tf_bits(key, (uint64_t)k * cols + t) & 0xFFFFFFu);
    const int top = w[(nwords - 1) * MASK_THREADS] & ((1 << top_bits) - 1);
    w[(nwords - 1) * MASK_THREADS] = top - (1 << (top_bits - 1));
    fold_rows(out_l + t, pw_l, q_l, mu_l, w, nwords, L, cols);
    fold_rows(out_f + t, pw_f, q_f, mu_f, w, nwords, Lf, cols);
}

__global__ void __launch_bounds__(THREADS)
bs_combine_kernel(uint32_t* __restrict__ h1, uint32_t* __restrict__ h2,
                  const uint32_t* __restrict__ c1, const uint32_t* __restrict__ crp,
                  const uint32_t* __restrict__ sk, const int* __restrict__ rows_l,
                  const int* __restrict__ rows_f, const uint32_t* __restrict__ e1,
                  const uint32_t* __restrict__ mask_l, const uint32_t* __restrict__ e2,
                  const uint32_t* __restrict__ mask_f, const uint32_t* __restrict__ q_l,
                  const uint32_t* __restrict__ q_f, const uint64_t* __restrict__ mu_l,
                  const uint64_t* __restrict__ mu_f, const int B, const int L, const int Lf,
                  const int logn) {
    const size_t n_ = (size_t)1 << logn;
    const size_t n1 = (size_t)B * L * n_;
    size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n1 + (size_t)B * Lf * n_) return;
    const bool first = i < n1;
    if (!first) i -= n1;
    const int R = first ? L : Lf;
    const size_t n = i & (n_ - 1);
    const int r = (int)((i >> logn) % (size_t)R);
    const int b = (int)((i >> logn) / (size_t)R);
    const size_t rb = ((size_t)r * B + b) * n_ + n;  // [rows, B, N] index
    if (first) {
        const uint32_t q = q_l[r];
        const uint64_t v = (uint64_t)c1[i] * sk[(size_t)rows_l[r] * n_ + n] + e1[rb] + mask_l[rb];
        h1[i] = barrett64(v, mu_l[r], q);
    } else {
        const uint32_t q = q_f[r];
        const uint64_t mu = mu_f[r];
        const uint32_t t = barrett64((uint64_t)crp[i] * sk[(size_t)rows_f[r] * n_ + n], mu, q);
        const uint64_t v = (uint64_t)e2[rb] + (q - t) + (q - mask_f[rb]);  // < 3q
        h2[i] = barrett64(v, mu, q);
    }
}

}  // namespace

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int bs_max_words() { return MAX_WORDS; }

// out_l [L, B, N], out_f [Lf, B, N] (coefficient domain); pw_* [rows, nwords]
// = 2^(24k) mod q; q_* [rows] uint32, mu_* [rows] uint64
int bs_mask(void* out_l, void* out_f, const void* pw_l, const void* pw_f, const void* q_l,
            const void* q_f, const void* mu_l, const void* mu_f, unsigned seed_lo,
            unsigned seed_hi, unsigned idx, int B, int nwords, int top_bits, int L, int Lf,
            int logn, void* stream) {
    if (B < 1 || nwords < 1 || nwords > MAX_WORDS || top_bits < 1 || top_bits > 24 || L < 0 ||
        Lf < 0 || logn < 1 || logn > 20)
        return (int)cudaErrorInvalidValue;
    const size_t cols = (size_t)B << logn;
    if ((cols + MASK_THREADS - 1) / MASK_THREADS > 0x7fffffffu) return (int)cudaErrorInvalidValue;
    const TfKey key = tf_derive_key(seed_lo, seed_hi, idx);
    const size_t smem = (size_t)nwords * MASK_THREADS * sizeof(int);
    bs_mask_kernel<<<(unsigned)((cols + MASK_THREADS - 1) / MASK_THREADS), MASK_THREADS, smem,
                     (cudaStream_t)stream>>>(
        (uint32_t*)out_l, (uint32_t*)out_f, (const uint32_t*)pw_l, (const uint32_t*)pw_f,
        (const uint32_t*)q_l, (const uint32_t*)q_f, (const uint64_t*)mu_l, (const uint64_t*)mu_f,
        key, B, nwords, top_bits, L, Lf, logn);
    return (int)cudaGetLastError();
}

// h1, c1 [B, L, N]; h2, crp [B, Lf, N]; sk [*, N]; rows_* int32 row indices
// into sk; e1, mask_l [L, B, N]; e2, mask_f [Lf, B, N]
int bs_combine(void* h1, void* h2, const void* c1, const void* crp, const void* sk,
               const void* rows_l, const void* rows_f, const void* e1, const void* mask_l,
               const void* e2, const void* mask_f, const void* q_l, const void* q_f,
               const void* mu_l, const void* mu_f, int B, int L, int Lf, int logn,
               void* stream) {
    if (B < 1 || L < 0 || Lf < 0 || L + Lf < 1 || logn < 1 || logn > 20)
        return (int)cudaErrorInvalidValue;
    const size_t total = (size_t)B * (L + Lf) << logn;
    if ((total + THREADS - 1) / THREADS > 0x7fffffffu) return (int)cudaErrorInvalidValue;
    bs_combine_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                        (cudaStream_t)stream>>>(
        (uint32_t*)h1, (uint32_t*)h2, (const uint32_t*)c1, (const uint32_t*)crp,
        (const uint32_t*)sk, (const int*)rows_l, (const int*)rows_f, (const uint32_t*)e1,
        (const uint32_t*)mask_l, (const uint32_t*)e2, (const uint32_t*)mask_f,
        (const uint32_t*)q_l, (const uint32_t*)q_f, (const uint64_t*)mu_l,
        (const uint64_t*)mu_f, B, L, Lf, logn);
    return (int)cudaGetLastError();
}

}  // extern "C"
