// The CKKS rescale of both components of a ciphertext in one C entry: divide
// by the last modulus q_l and drop its limb.
//
// Replaces no TPU kernel: the reference runs a rescale as, per component, an
// inverse NTT of the dropped limb, the centred re-embedding of its
// coefficients in every remaining limb in int64 arithmetic, a forward NTT over
// the l remaining limbs, a submod and a mulmod by [q_l^{-1}]
// (src/repro/fhe/ops.py, _rescale): some 14 launches a component.  A rescale
// is a ModDown by the one modulus q_l, so this is fused_moddown (fusedks.cu)
// with the BConv replaced by the centred one-limb conversion:
//   r_e = v mod q_e        if v <= floor(q_l / 2),
//   r_e = (v − q_l) mod q_e  otherwise,
// for each coefficient v of the dropped limb, exactly as the reference
// centres.  Both branches go through one montmul with the twist psi_e·R,
// which reduces any operand below 2^32: v, or v + (q_e − q_l mod q_e).
//
// Four kernels in stream order, many blocks per limb (ntt_passes.cuh):
//   intt pass 1 and pass 2, one block per (component, tile): the inverse NTT
//     of c0[l] and c1[l], given as two pointers, into a (2, N) coefficient
//     scratch;
//   pass A, one block per (row c·l + e, column tile): the centred conversion
//     of component c's coefficients to q_e, the twist, the N1-point column
//     NTTs and the inter-pass twiddle, into a (2, l, N) scratch;
//   pass B, one block per (row c·l + e, row tile): the row NTTs and
//     out_c[e] = (c[e] − ŷ)·q_l^{-1}, by a montmul with [q_l^{-1}]·R, into one
//     (l, N) tensor a component, so that neither output keeps the other alive.
// At packed_bootstrap's top rescale (l = 57 remaining limbs, N = 2^16) passes
// A and B run 1824 blocks each, the inverse NTT 32 each, on 132 SMs.
//
// Bound on the H100: operations.  The 2 + 2·l NTT rows cost ~N/2·log2(N)
// butterflies each, ≈ 1.0 G integer operations at l = 57, N = 2^16 (≈ 30 us at
// the issue rate), against 60 MB read and written (≈ 18 us at 3.35 TB/s): the
// 2·(l + 1) input limbs and 2·l output limbs.  The scratch (29 MB there) moves
// through the 50 MB L2, and each pass-A block rereads its column tile of the
// coefficients (512 KiB in all) from L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_passes.cuh"

namespace {

// Pass 1 of an NTT for one row, run by the whole block for column tile
// blockIdx.x: each thread's PASS_SLOTS inputs come from load(i) at their
// natural-order indices i, then the N1-point column NTTs over roots (the
// limb's w^i·R or w^-i·R) and y[i] = v·tw[i].  The mirror of row_ntt_pass.
template <class Load>
__device__ __forceinline__ void column_ntt_pass(const uint32_t* __restrict__ roots, const uint32_t* __restrict__ tw,
                                                uint32_t q, uint32_t qinv, uint32_t* __restrict__ y, int log_n,
                                                Load load) {
    __shared__ uint32_t tile[PASS_TILE_WORDS];
    __shared__ uint32_t sub[1 << (PASS_MAX_LOG_M - 1)];
    const int log_n1 = pass_log_n1(log_n);
    const int log_n2 = log_n - log_n1;
    const int c0 = blockIdx.x * PASS_TILE;
    load_sub_roots(sub, roots, log_n1, log_n2);
    __syncthreads();
    dif_columns(
        tile, PASS_TILE, 1, log_n1, sub, q, qinv,
        [&](const int* pos, int col, uint32_t* v) {
#pragma unroll
            for (int x = 0; x < PASS_SLOTS; ++x) v[x] = load((static_cast<size_t>(pos[x]) << log_n2) + c0 + col);
        },
        [&](int pos, int col, int, uint32_t v) {
            const size_t i = (static_cast<size_t>(rev_bits(pos, log_n1)) << log_n2) + c0 + col;
            y[i] = montmul(v, tw[i], q, qinv);
        });
}

// Tables (uint32, Montgomery where marked):
//   last:     (3,)    q_l, −q_l^{-1} mod 2^32, floor(q_l / 2)
//   twinv_l, winv_l, twist_l: (n,)  q_l's inverse inter-pass twiddles, w^-i and psi^-i·N^-1, ·R
//   q/qinv:   (l,)    the remaining basis q_0..q_{l-1}
//   psi_m, roots_m, tw_m: (l, n)  their forward NTT tables, ·R
//   neg:      (l,)    q_e − (q_l mod q_e)
//   qlinv_m:  (l,)    [q_l^{-1}]_{q_e}·R
//   y:        (2, n)  the inverse NTT's intermediate; coeff: (2, n) its output
//   scratch:  (2, l, n) pass A's output, pass B's input
//   out0, out1: (l, n) each, the two components' outputs
// Inverse pass 1: block (column tile, component c).
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    rescale_intt_pass1(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ x1,
                       const uint32_t* __restrict__ last, const uint32_t* __restrict__ winv_l,
                       const uint32_t* __restrict__ twinv_l, uint32_t* __restrict__ y, int log_n) {
    const uint32_t* x = blockIdx.y ? x1 : x0;
    column_ntt_pass(winv_l, twinv_l, last[0], last[1], y + (static_cast<size_t>(blockIdx.y) << log_n), log_n,
                    [&](size_t i) { return x[i]; });
}

// Inverse pass 2: block (row tile, component c).
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    rescale_intt_pass2(const uint32_t* __restrict__ y, const uint32_t* __restrict__ last,
                       const uint32_t* __restrict__ winv_l, const uint32_t* __restrict__ twist_l,
                       uint32_t* __restrict__ coeff, int log_n) {
    const uint32_t q = last[0];
    const uint32_t qi = last[1];
    const size_t at = static_cast<size_t>(blockIdx.y) << log_n;
    uint32_t* out = coeff + at;
    row_ntt_pass(y + at, winv_l, q, qi, log_n, [&](size_t i, uint32_t v) { out[i] = montmul(v, twist_l[i], q, qi); });
}

// Pass A: block (column tile, row c·l + e).
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    rescale_pass_a(const uint32_t* __restrict__ coeff, const uint32_t* __restrict__ last, int nq,
                   const uint32_t* __restrict__ q, const uint32_t* __restrict__ qinv,
                   const uint32_t* __restrict__ neg, const uint32_t* __restrict__ psi_m,
                   const uint32_t* __restrict__ roots_m, const uint32_t* __restrict__ tw_m,
                   uint32_t* __restrict__ scratch, int log_n) {
    const int row = blockIdx.y;
    const int e = row % nq;
    const uint32_t qe = q[e];
    const uint32_t qi = qinv[e];
    const uint32_t half = last[2];
    const uint32_t shift = neg[e];
    const size_t at = static_cast<size_t>(e) << log_n;
    const uint32_t* v = coeff + (static_cast<size_t>(row / nq) << log_n);
    const uint32_t* psi = psi_m + at;
    column_ntt_pass(roots_m + at, tw_m + at, qe, qi, scratch + (static_cast<size_t>(row) << log_n), log_n,
                    [&](size_t i) {
                        const uint32_t c = v[i];  // < q_l < 2^31, so c + shift < 2^32
                        return montmul(c > half ? c + shift : c, psi[i], qe, qi);
                    });
}

// Pass B: block (row tile, row c·l + e).
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    rescale_pass_b(const uint32_t* __restrict__ scratch, int nq, const uint32_t* __restrict__ q,
                   const uint32_t* __restrict__ qinv, const uint32_t* __restrict__ roots_m,
                   const uint32_t* __restrict__ c0, const uint32_t* __restrict__ c1,
                   const uint32_t* __restrict__ qlinv_m, uint32_t* __restrict__ out0, uint32_t* __restrict__ out1,
                   int log_n) {
    const int row = blockIdx.y;
    const int e = row % nq;
    const uint32_t qe = q[e];
    const uint32_t qi = qinv[e];
    const uint32_t qlinv = qlinv_m[e];
    const size_t limb = static_cast<size_t>(e) << log_n;
    const uint32_t* ce = (row < nq ? c0 : c1) + limb;
    uint32_t* outr = (row < nq ? out0 : out1) + limb;
    row_ntt_pass(scratch + (static_cast<size_t>(row) << log_n), roots_m + limb, qe, qi, log_n,
                 [&](size_t i, uint32_t v) { outr[i] = montmul(submod(ce[i], v, qe), qlinv, qe, qi); });
}

}  // namespace

// c0, c1: (nq + 1, n) eval-domain components; out0, out1: (nq, n) each; work:
// (2·nq + 4, n) words, overlapping none of them; n = 2^log_n with 8 <= log_n <= 16.
// Returns cudaGetLastError() after the launches.
extern "C" int fused_rescale_launch(const void* c0, const void* c1, int nq, const void* last, const void* twinv_l,
                                    const void* winv_l, const void* twist_l, const void* q, const void* qinv,
                                    const void* neg, const void* psi_m, const void* roots_m, const void* tw_m,
                                    const void* qlinv_m, void* out0, void* out1, void* work, int n, int log_n,
                                    void* stream) {
    if (!pass_size_ok(log_n) || n != (1 << log_n) || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* a = static_cast<const uint32_t*>(c0);
    const auto* b = static_cast<const uint32_t*>(c1);
    const auto* lt = static_cast<const uint32_t*>(last);
    const auto* qq = static_cast<const uint32_t*>(q);
    const auto* qi = static_cast<const uint32_t*>(qinv);
    const auto* roots = static_cast<const uint32_t*>(roots_m);
    const size_t limb = static_cast<size_t>(n);
    uint32_t* scratch = static_cast<uint32_t*>(work);
    uint32_t* y = scratch + 2 * nq * limb;
    uint32_t* coeff = y + 2 * limb;
    const PassGrids gi = pass_grids(2, log_n);
    const PassGrids g = pass_grids(2 * nq, log_n);
    rescale_intt_pass1<<<gi.grid1, gi.block1, 0, s>>>(a + nq * limb, b + nq * limb, lt,
                                                       static_cast<const uint32_t*>(winv_l),
                                                       static_cast<const uint32_t*>(twinv_l), y, log_n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rescale_intt_pass2<<<gi.grid2, gi.block2, 0, s>>>(y, lt, static_cast<const uint32_t*>(winv_l),
                                                       static_cast<const uint32_t*>(twist_l), coeff, log_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rescale_pass_a<<<g.grid1, g.block1, 0, s>>>(coeff, lt, nq, qq, qi, static_cast<const uint32_t*>(neg),
                                                static_cast<const uint32_t*>(psi_m), roots,
                                                static_cast<const uint32_t*>(tw_m), scratch, log_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rescale_pass_b<<<g.grid2, g.block2, 0, s>>>(scratch, nq, qq, qi, roots, a, b,
                                                static_cast<const uint32_t*>(qlinv_m), static_cast<uint32_t*>(out0),
                                                static_cast<uint32_t*>(out1), log_n);
    return static_cast<int>(cudaGetLastError());
}
