// Fast basis conversion, shared by bconv.cu, fusedks.cu and hoistrot.cu: one
// output coefficient (bconv_coeff), several at once (bconv_coeffs, fused_ks's
// pass A), and one whole ModUp row (modup_row).
//
// Conv_{B→C}(x)[e, i] = Σ_s x̂_s[i]·(B̂_s mod c_e)  (mod c_e), with
// x̂_s = x_s·[B̂_s^{-1}]_{b_s} mod b_s.  Every term is one montmul against the
// weight held in Montgomery form (W·R mod c_e), so it is reduced mod c_e
// before it is added: the rule of src/repro/kernels/bconv/ref.py:28.  The
// result is canonical in [0, c_e), so it is bit-identical to the plain version.
#pragma once

#include <cstddef>
#include <cstdint>

#include "montgomery.cuh"
#include "ntt_core.cuh"

// Source rows s in [lo, hi) of x (row s at x + s·n), coefficient i, to target
// limb e of modulus c.  w_m is (rows, m) row-major: w_m[s·m + e] = W[s, e]·R.
// With PRESCALE, row s is first multiplied by bh_m[s] = [B̂_s^{-1}]·R mod b_s
// (b_s = src_q[s]); without it x already holds x̂ and the src tables are unused.
template <bool PRESCALE>
__device__ __forceinline__ uint32_t bconv_coeff(const uint32_t* __restrict__ x, size_t i, int n, int lo, int hi,
                                                const uint32_t* __restrict__ bh_m,
                                                const uint32_t* __restrict__ src_q,
                                                const uint32_t* __restrict__ src_qinv,
                                                const uint32_t* __restrict__ w_m, int m, int e, uint32_t c,
                                                uint32_t cinv) {
    uint32_t y = 0;
    for (int s = lo; s < hi; ++s) {
        uint32_t xh = x[static_cast<size_t>(s) * n + i];
        if constexpr (PRESCALE) xh = montmul(xh, bh_m[s], src_q[s], src_qinv[s]);
        y = addmod(y, montmul(xh, w_m[static_cast<size_t>(s) * m + e], c, cinv), c);
    }
    return y;
}

// bconv_coeff<true> for K coefficients i[0..K) of one target limb at once, into
// y[0..K): the same terms, reduced and added in the same order, with the source
// loop outermost so that a thread has K independent loads in flight.
template <int K>
__device__ __forceinline__ void bconv_coeffs(uint32_t* y, const uint32_t* __restrict__ x, const size_t* i, int n,
                                             int lo, int hi, const uint32_t* __restrict__ bh_m,
                                             const uint32_t* __restrict__ src_q,
                                             const uint32_t* __restrict__ src_qinv,
                                             const uint32_t* __restrict__ w_m, int m, int e, uint32_t c,
                                             uint32_t cinv) {
#pragma unroll
    for (int k = 0; k < K; ++k) y[k] = 0;
    for (int s = lo; s < hi; ++s) {
        const uint32_t* xs = x + static_cast<size_t>(s) * n;
        const uint32_t bh = bh_m[s];
        const uint32_t qs = src_q[s];
        const uint32_t qsinv = src_qinv[s];
        const uint32_t w = w_m[static_cast<size_t>(s) * m + e];
        uint32_t v[K];
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = xs[i[k]];
#pragma unroll
        for (int k = 0; k < K; ++k) y[k] = addmod(y[k], montmul(montmul(v[k], bh, qs, qsinv), w, c, cinv), c);
    }
}

// One ModUp row, run by the whole block: BConv of source rows [lo, hi) of x to
// target limb e (prescaled, as bconv_coeff<true>), twisted by psi_m[e] into
// its bit-reversed slot of buf, then the forward NTT over roots_m[e].  buf is
// the block's working limb (ntt_buffer); on return it holds the row in the
// evaluation domain, natural order, behind a barrier.  The fused_ks,
// fused_moddown and hoist_modup kernels run their ModUp through this one copy.
__device__ __forceinline__ void modup_row(uint32_t* buf, const uint32_t* __restrict__ x, int n, int log_n, int lo,
                                          int hi, const uint32_t* __restrict__ bh_m,
                                          const uint32_t* __restrict__ src_q,
                                          const uint32_t* __restrict__ src_qinv,
                                          const uint32_t* __restrict__ w_m, int m, int e, uint32_t c, uint32_t cinv,
                                          const uint32_t* __restrict__ psi_m,
                                          const uint32_t* __restrict__ roots_m) {
    const uint32_t* psi = psi_m + static_cast<size_t>(e) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint32_t y = bconv_coeff<true>(x, i, n, lo, hi, bh_m, src_q, src_qinv, w_m, m, e, c, cinv);
        buf[bitrev(i, log_n)] = montmul(y, psi[i], c, cinv);
    }
    ntt_dit_stages(buf, roots_m + static_cast<size_t>(e) * n, n, log_n, c, cinv);
}
