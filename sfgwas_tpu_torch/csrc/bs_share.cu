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
// (subtracts h = 2^(top_bits-1)), so the mask is the signed integer
//   v = sum_k w_k 2^(24k) - h 2^(24(nwords-1)),  |v| < 2^(24(nwords-1) + top_bits - 1).
// It writes v mod q for every row of `rows` ([L, B, N]) and of `tgt_rows`
// ([Lf, B, N]) in the coefficient domain, from the weights p_k = 2^(24k) mod q:
// the top word is folded unsigned, and the centring is the row's constant
// -h p_top mod q, exact for any q.
//
// bs_combine (:630-647): with the masks in the NTT domain,
//   h1[b, r] = c1[b, r] * s[rows[r]] + e1[r, b] + mask_l[r, b]          mod q_r
//   h2[b, r] = -crp[b, r] * s[tgt_rows[r]] + e2[r, b] - mask_f[r, b]    mod q_r
// in one pass over both outputs.
//
// What bounds them on the H100: bs_mask by issued integer instructions
// (nwords Threefry-2x32 words of 73 instructions per coefficient, then a
// fold per row, against 4 (L + Lf) written bytes), bs_combine by bytes (it
// reads 3 streamed inputs and writes one residue per output).
//
// bs_mask's first design kept each thread's words in shared memory that only
// it read, and folded every row through a loop over a runtime word count,
// reducing each word's term before adding the next: a row was a chain of
// nwords dependent steps.  This design, for every count up to REG_WORDS =
// 18 (PN14QP438's widest mask):
//  * folds from registers (a template over nwords);
//  * gives a thread 4 consecutive coefficients of one b, whose hashes run
//    together (threefry.cuh), two words (8 counters) at a time, into a
//    shared tile that the thread reads back, one 16-byte entry a word; one
//    16-byte store per row; b is the grid's y index, so the counters' high
//    words and the row constants are the block's;
//  * folds each word (below 2^24) by a Shoup multiply with p_k and its
//    quotient ps_k = floor(p_k 2^32 / q) into [0, 2q), adds every word's
//    term and the row's centring constant in (0, 2q] without a reduction
//    between them, and reduces the sum once with one 32-bit Barrett step
//    (m = floor(2^32 / q), the high word of mu) and a conditional subtract.
//    The lazy sum stays below 2q (nwords + 1), so the wrapper takes this
//    kernel only where 2 (nwords + 1) q_max < 2^32 for the table's largest
//    prime (mhe.py bs_lazy; at PN14QP438's primes below 2^25.2, up to 58
//    words).  Shoup's fold needs no other bound on q: a word may exceed it;
//  * on grids too small to fill the card (mhe.py bs_mask_split: fewer than
//    four blocks an SM), 2 or 4 warps share a run of coefficients: each
//    hashes its part of the words into the tile, and each folds its part of
//    the rows from all the words.  On an H100 at 10 words, B 12 (384
//    blocks) the mask took 0.022 ms against the generic kernel's 0.050, and
//    the widest mask of one refresh (18 words, B 1, 32 blocks) 0.0093 at 4
//    warps against 0.028 unsplit.  A thread that kept its words in
//    registers throughout, hashing up to 4 words at once, was no faster
//    (3-4% ahead at 3 words, B 64; 5-11% behind at the main path's shapes).
// In SASS (cuobjdump, nwords 3) the hashes take about 70 instructions a
// word and the row loop 102 for 4 coefficients, 74 of them IMAD: from about
// a dozen rows on, the folds' multiplies on the FMA pipe outweigh the
// hashes' rotates and xors on the ALU pipe.
// Masks of more than REG_WORDS words, tables past the lazy bound and rings
// of N < 4 take the generic kernel, for up to MAX_WORDS words: the first
// design, exact for any q < 2^31.

#include <utility>

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int MASK_THREADS = 128;
constexpr int MASK_VEC = 4;     // coefficients a thread in bs_mask_kernel
constexpr int REG_WORDS = 18;   // the most words bs_mask_kernel takes
constexpr int MAX_WORDS = 96;  // 96 * 128 * 4 = 48 KB of shared memory, no opt-in
constexpr int THREADS = 256;

// 2q - (h p mod q up to one q), in (0, 2q]: -h p mod q, offset by a multiple of q
__device__ __forceinline__ uint32_t centring(uint32_t h, uint32_t p, uint32_t ps, uint32_t q) {
    return 2 * q - shoup_lazy(h, p, ps, q);
}

template <int K>
__device__ __forceinline__ void fold_rows_v(uint32_t* __restrict__ out,
                                            const uint32_t* __restrict__ pw,
                                            const uint32_t* __restrict__ ps,
                                            const uint32_t* __restrict__ qv,
                                            const uint64_t* __restrict__ muv,
                                            const uint32_t (&w)[K * MASK_VEC], uint32_t h,
                                            int r0, int rows, int step, size_t row_stride) {
    // two rows a pass: at 11 words the loop alone left ptxas spilling
#pragma unroll 2
    for (int r = r0; r < rows; r += step) {
        const uint32_t q = __ldg(qv + r), m = (uint32_t)(__ldg(muv + r) >> 32);
        uint32_t p[K], s[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            p[k] = __ldg(pw + r * K + k);
            s[k] = __ldg(ps + r * K + k);
        }
        const uint32_t c = centring(h, p[K - 1], s[K - 1], q);
        uint32_t o[MASK_VEC];
#pragma unroll
        for (int v = 0; v < MASK_VEC; ++v) {
            uint32_t acc = c;
#pragma unroll
            for (int k = 0; k < K; ++k) acc += shoup_lazy(w[k * MASK_VEC + v], p[k], s[k], q);
            o[v] = sub_if_ge(barrett32_lazy(acc, m, q), q);
        }
        *reinterpret_cast<uint4*>(out + r * row_stride) = make_uint4(o[0], o[1], o[2], o[3]);
    }
}

// words k..k+C-1 of the thread's run, hashed together, into the block's
// word tile [K][runs] (one 16-byte entry a word and run)
template <int C>
__device__ __forceinline__ void hash_store(const TfKey key, uint4* tile, const int k, const int runs,
                                           const int run, const uint64_t cols, const uint64_t bn,
                                           const uint32_t n0) {
    // counter (k*B + b)*N + n: the base is a multiple of N, n < N, so the
    // low word never carries
    uint32_t x0[C * MASK_VEC], x1[C * MASK_VEC];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const uint64_t base = (uint64_t)(k + c) * cols + bn;
#pragma unroll
        for (int v = 0; v < MASK_VEC; ++v) {
            x0[c * MASK_VEC + v] = (uint32_t)(base >> 32);
            x1[c * MASK_VEC + v] = (uint32_t)base + n0 + v;
        }
    }
    tf_bits_v(key, x0, x1);
#pragma unroll
    for (int c = 0; c < C; ++c)
        tile[(k + c) * runs + run] = make_uint4(x0[c * MASK_VEC], x0[c * MASK_VEC + 1],
                                                x0[c * MASK_VEC + 2], x0[c * MASK_VEC + 3]);
}

// split = G (1, 2 or 4) warps share 32 runs of MASK_VEC coefficients: warp
// role j = w mod G hashes words [j M, j M + M) (M = ceil(K / G)), two at a
// time, into the block's shared word tile, every thread reads its run's K
// words back into registers and folds rows j, j + G, ... of the L + Lf
// rows.  No hash is repeated.
template <int K>
__global__ void __launch_bounds__(MASK_THREADS)
bs_mask_kernel(uint32_t* __restrict__ out_l, uint32_t* __restrict__ out_f,
               const uint32_t* __restrict__ pw_l, const uint32_t* __restrict__ pw_f,
               const uint32_t* __restrict__ ps_l, const uint32_t* __restrict__ ps_f,
               const uint32_t* __restrict__ q_l, const uint32_t* __restrict__ q_f,
               const uint64_t* __restrict__ mu_l, const uint64_t* __restrict__ mu_f,
               const TfKey key, const int B, const int top_bits, const int L, const int Lf,
               const int logn, const int split) {
    extern __shared__ uint4 tile[];  // [K][runs]
    const int G = split, runs = MASK_THREADS / G;
    const int warp = threadIdx.x >> 5, role = warp % G;
    const int run = (warp / G) * 32 + (threadIdx.x & 31);
    const uint32_t n0 = (blockIdx.x * runs + run) * MASK_VEC;
    const bool active = !(n0 >> logn);
    const size_t cols = (size_t)B << logn;
    const uint32_t h = 1u << (top_bits - 1);
    const int M = (K + G - 1) / G, k0 = min(K, role * M), k1 = min(K, k0 + M);
    for (int b = blockIdx.y; b < B; b += gridDim.y) {
        const uint64_t bn = (uint64_t)b << logn;
        uint32_t w[K * MASK_VEC];
        if (active) {
            int k = k0;
            for (; k + 2 <= k1; k += 2) hash_store<2>(key, tile, k, runs, run, cols, bn, n0);
            if (k < k1) hash_store<1>(key, tile, k, runs, run, cols, bn, n0);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const uint4 t = tile[k * runs + run];
            w[k * MASK_VEC] = t.x;
            w[k * MASK_VEC + 1] = t.y;
            w[k * MASK_VEC + 2] = t.z;
            w[k * MASK_VEC + 3] = t.w;
        }
        __syncthreads();  // the next b's words overwrite the tile
        if (!active) continue;
#pragma unroll
        for (int i = 0; i < K * MASK_VEC; ++i)
            w[i] &= i < (K - 1) * MASK_VEC ? 0xFFFFFFu : (1u << top_bits) - 1;
        const size_t off = bn + n0;
        // row r of out_f is row L + r of the two sets together
        fold_rows_v<K>(out_l + off, pw_l, ps_l, q_l, mu_l, w, h, role, L, G, cols);
        fold_rows_v<K>(out_f + off, pw_f, ps_f, q_f, mu_f, w, h, (role + G - L % G) % G, Lf, G,
                       cols);
    }
}

__device__ __forceinline__ void fold_rows(uint32_t* __restrict__ out,
                                          const uint32_t* __restrict__ pw,
                                          const uint32_t* __restrict__ ps,
                                          const uint32_t* __restrict__ qv, const uint32_t* w,
                                          uint32_t h, int nwords, int rows, size_t row_stride) {
    for (int r = 0; r < rows; ++r) {
        const uint32_t q = __ldg(qv + r);
        const uint32_t* p = pw + (size_t)r * nwords;
        const uint32_t* s = ps + (size_t)r * nwords;
        // -h p_top mod q, then one word's term at a time, the sum kept below q
        const int t = nwords - 1;
        uint32_t acc = sub_if_ge(q - sub_if_ge(shoup_lazy(h, __ldg(p + t), __ldg(s + t), q), q), q);
        for (int k = 0; k < nwords; ++k) {
            const uint32_t v = shoup_lazy(w[k * MASK_THREADS], __ldg(p + k), __ldg(s + k), q);
            acc = sub_if_ge(acc + sub_if_ge(v, q), q);
        }
        out[r * row_stride] = acc;
    }
}

__global__ void __launch_bounds__(MASK_THREADS)
bs_mask_generic_kernel(uint32_t* __restrict__ out_l, uint32_t* __restrict__ out_f,
                       const uint32_t* __restrict__ pw_l, const uint32_t* __restrict__ pw_f,
                       const uint32_t* __restrict__ ps_l, const uint32_t* __restrict__ ps_f,
                       const uint32_t* __restrict__ q_l, const uint32_t* __restrict__ q_f,
                       const TfKey key, const int B, const int nwords, const int top_bits,
                       const int L, const int Lf, const int logn) {
    extern __shared__ uint32_t ws[];  // [nwords][MASK_THREADS]
    const size_t cols = (size_t)B << logn;
    const size_t t = (size_t)blockIdx.x * MASK_THREADS + threadIdx.x;
    if (t >= cols) return;
    uint32_t* w = ws + threadIdx.x;
    for (int k = 0; k < nwords; ++k)
        w[k * MASK_THREADS] = tf_bits(key, (uint64_t)k * cols + t) & 0xFFFFFFu;
    w[(nwords - 1) * MASK_THREADS] &= (1u << top_bits) - 1;
    const uint32_t h = 1u << (top_bits - 1);
    fold_rows(out_l + t, pw_l, ps_l, q_l, w, h, nwords, L, cols);
    fold_rows(out_f + t, pw_f, ps_f, q_f, w, h, nwords, Lf, cols);
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

using MaskKernel = decltype(&bs_mask_kernel<1>);

// bs_mask_kernel<nwords>, nwords in 1..REG_WORDS
template <int... Is>
MaskKernel reg_kernel(int nwords, std::integer_sequence<int, Is...>) {
    static const MaskKernel table[] = {bs_mask_kernel<Is + 1>...};
    return table[nwords - 1];
}

bool mask_args_ok(void* out_l, void* out_f, int B, int nwords, int top_bits, int L, int Lf,
                  int logn) {
    if (B < 1 || nwords < 1 || top_bits < 1 || top_bits > 24 || L < 0 || Lf < 0 || logn < 1 ||
        logn > 20 || (uintptr_t)out_l % 16 || (uintptr_t)out_f % 16)
        return false;
    const size_t cols = (size_t)B << logn;
    return (cols + MASK_THREADS - 1) / MASK_THREADS <= 0x7fffffffu;
}

}  // namespace

extern "C" {

const char* csrc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int bs_max_words() { return MAX_WORDS; }

int bs_reg_words() { return REG_WORDS; }

// out_l [L, B, N], out_f [Lf, B, N] (coefficient domain, 16-byte aligned);
// pw_* [rows, nwords] = 2^(24k) mod q and ps_* their Shoup quotients
// floor(pw 2^32 / q); q_* [rows] uint32 (< 2^31), mu_* [rows] uint64.
// The register kernel: nwords 1..REG_WORDS, N >= 4, and the caller
// vouches that 2 (nwords + 1) q < 2^32 for every prime of both row sets;
// split (1, 2 or 4) warps share a run of coefficients.
int bs_mask(void* out_l, void* out_f, const void* pw_l, const void* pw_f, const void* ps_l,
            const void* ps_f, const void* q_l, const void* q_f, const void* mu_l,
            const void* mu_f, unsigned seed_lo, unsigned seed_hi, unsigned idx, int B,
            int nwords, int top_bits, int L, int Lf, int logn, int split, void* stream) {
    if (!mask_args_ok(out_l, out_f, B, nwords, top_bits, L, Lf, logn) || nwords > REG_WORDS ||
        logn < 2 || (split != 1 && split != 2 && split != 4))
        return (int)cudaErrorInvalidValue;
    const int per_block = MASK_THREADS / split * MASK_VEC;  // coefficients
    const dim3 grid((unsigned)(((1 << logn) + per_block - 1) / per_block),
                    (unsigned)(B < 65535 ? B : 65535));
    const size_t smem = (size_t)nwords * (MASK_THREADS / split) * sizeof(uint4);
    const MaskKernel kernel = reg_kernel(nwords, std::make_integer_sequence<int, REG_WORDS>{});
    kernel<<<grid, MASK_THREADS, smem, (cudaStream_t)stream>>>(
        (uint32_t*)out_l, (uint32_t*)out_f, (const uint32_t*)pw_l, (const uint32_t*)pw_f,
        (const uint32_t*)ps_l, (const uint32_t*)ps_f, (const uint32_t*)q_l, (const uint32_t*)q_f,
        (const uint64_t*)mu_l, (const uint64_t*)mu_f, tf_derive_key(seed_lo, seed_hi, idx), B,
        top_bits, L, Lf, logn, split);
    return (int)cudaGetLastError();
}

// the generic kernel: the same arguments but mu (which it does not read),
// nwords 1..MAX_WORDS, any N and any prime below 2^31
int bs_mask_generic(void* out_l, void* out_f, const void* pw_l, const void* pw_f,
                    const void* ps_l, const void* ps_f, const void* q_l, const void* q_f,
                    unsigned seed_lo, unsigned seed_hi, unsigned idx, int B, int nwords,
                    int top_bits, int L, int Lf, int logn, void* stream) {
    if (!mask_args_ok(out_l, out_f, B, nwords, top_bits, L, Lf, logn) || nwords > MAX_WORDS)
        return (int)cudaErrorInvalidValue;
    const size_t cols = (size_t)B << logn;
    const size_t smem = (size_t)nwords * MASK_THREADS * sizeof(uint32_t);
    bs_mask_generic_kernel<<<(unsigned)((cols + MASK_THREADS - 1) / MASK_THREADS), MASK_THREADS,
                             smem, (cudaStream_t)stream>>>(
        (uint32_t*)out_l, (uint32_t*)out_f, (const uint32_t*)pw_l, (const uint32_t*)pw_f,
        (const uint32_t*)ps_l, (const uint32_t*)ps_f, (const uint32_t*)q_l, (const uint32_t*)q_f,
        tf_derive_key(seed_lo, seed_hi, idx), B, nwords, top_bits, L, Lf, logn);
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
