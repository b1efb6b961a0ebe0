// Fast basis conversion with the prescale, shared by fusedks.cu and
// hoistrot.cu: several output coefficients of one target limb at once
// (bconv_coeffs), and pass A of a two-pass ModUp (modup_pass_a), which
// fused_ks, fused_moddown and hoist_modup run.
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
#include "ntt_passes.cuh"

// K coefficients i[0..K) of target limb e (modulus c) at once, into y[0..K),
// from source rows s in [lo, hi) of x (row s at x + s·n, modulus src_q[s]):
// each row is first multiplied by bh_m[s] = [B̂_s^{-1}]·R mod src_q[s], then
// every term by w_m[s·m + e] = W[s, e]·R mod c, reduced before it is added.
// The source loop is outermost, so that a thread has K independent loads in
// flight.
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

// Pass A of a two-pass ModUp (ntt_passes.cuh), run by the whole block for
// column tile blockIdx.x of one target row: the prescaled BConv of source rows
// [lo, hi) of x (row s at x + s·N, modulus src_q[s]) to limb e of modulus c,
// PASS_SLOTS coefficients a thread at once (bconv_coeffs), each twisted by
// psi, then the N1-point column NTTs over roots and the inter-pass twiddle tw,
// stored to y.  psi, roots and tw are the target limb's rows (·R); w_m is
// (rows, m) as for bconv_coeffs.  Pass 2 of the forward NTT (row_ntt_pass)
// finishes the row.
__device__ __forceinline__ void modup_pass_a(const uint32_t* __restrict__ x, int lo, int hi,
                                             const uint32_t* __restrict__ bh_m, const uint32_t* __restrict__ src_q,
                                             const uint32_t* __restrict__ src_qinv,
                                             const uint32_t* __restrict__ w_m, int m, int e, uint32_t c,
                                             uint32_t cinv, const uint32_t* __restrict__ psi,
                                             const uint32_t* __restrict__ roots, const uint32_t* __restrict__ tw,
                                             uint32_t* __restrict__ y, int log_n) {
    __shared__ uint32_t tile[PASS_TILE_WORDS];
    __shared__ uint32_t sub[1 << (PASS_MAX_LOG_M - 1)];
    const int log_n1 = pass_log_n1(log_n);
    const int log_n2 = log_n - log_n1;
    const int c0 = blockIdx.x * PASS_TILE;
    load_sub_roots(sub, roots, log_n1, log_n2);
    __syncthreads();
    dif_columns(
        tile, PASS_TILE, 1, log_n1, sub, c, cinv,
        [&](const int* pos, int col, uint32_t* v) {
            size_t i[PASS_SLOTS];
#pragma unroll
            for (int k = 0; k < PASS_SLOTS; ++k) i[k] = (static_cast<size_t>(pos[k]) << log_n2) + c0 + col;
            bconv_coeffs<PASS_SLOTS>(v, x, i, 1 << log_n, lo, hi, bh_m, src_q, src_qinv, w_m, m, e, c, cinv);
#pragma unroll
            for (int k = 0; k < PASS_SLOTS; ++k) v[k] = montmul(v[k], psi[i[k]], c, cinv);
        },
        [&](int pos, int col, int, uint32_t v) {
            const size_t i = (static_cast<size_t>(rev_bits(pos, log_n1)) << log_n2) + c0 + col;
            y[i] = montmul(v, tw[i], c, cinv);
        });
}

// Pass A of the digits' ModUp (fused_ks, hoist_modup): block (column tile,
// row j·m + e) converts digit j's source limbs of d (nq limbs in digits of
// alpha, the last one ragged) to extended limb e, into row j·m + e of a
// (β, m, N) scratch.  Source limb s < nq has modulus ext_q[s]; bh_m is (nq,),
// w_m (nq, m), and psi_m, roots_m, tw_m are (m, N).
__device__ __forceinline__ void digits_pass_a(const uint32_t* __restrict__ d, int nq, int alpha,
                                              const uint32_t* __restrict__ ext_q,
                                              const uint32_t* __restrict__ ext_qinv,
                                              const uint32_t* __restrict__ bh_m, const uint32_t* __restrict__ w_m,
                                              int m, const uint32_t* __restrict__ psi_m,
                                              const uint32_t* __restrict__ roots_m,
                                              const uint32_t* __restrict__ tw_m, uint32_t* __restrict__ scratch,
                                              int log_n) {
    const int row = blockIdx.y;
    const int e = row % m;
    const int lo = row / m * alpha;
    const size_t at = static_cast<size_t>(e) << log_n;
    modup_pass_a(d, lo, min(lo + alpha, nq), bh_m, ext_q, ext_qinv, w_m, m, e, ext_q[e], ext_qinv[e], psi_m + at,
                 roots_m + at, tw_m + at, scratch + (static_cast<size_t>(row) << log_n), log_n);
}
