// The fused key-switch pipeline: prescale -> BConv -> NTT -> key MAC for
// every digit (fused_ks), and the fused ModDown tail (fused_moddown).  Each is
// one C entry that starts two kernels, many thread blocks per limb.
//
// Replaces the Pallas kernels fused_ks_pallas and fused_moddown_pallas
// (src/repro/kernels/fusedks/kernel.py:121, 178).  On the TPU the digit axis j
// was the innermost sequential grid axis, accumulating through
// pl.when(j == 0).  BConv reduces every x̂_i·W[i, e] term mod c_e before
// adding (the rule of src/repro/kernels/bconv/ref.py:28, bconv_core.cuh).
// The TPU's 8-bit-limb MXU dots and its zero-padded digit rows with the dummy
// modulus 3 have no place here: each digit loops over its own limb count.
//
// Both run the two passes of ntt_passes.cuh, so that many blocks share each
// row:
//   fused_ks pass A, one block per (row j·m + e, column tile): modup_pass_a
//     (bconv_core.cuh), the BConv of digit j's source limbs at the tile's
//     coefficients, 8 loads in flight a thread, the twist by psi_e, the
//     N1-point column NTTs and the inter-pass twiddle, into a (β, m, N)
//     scratch, which at lstm (11 MiB) stays in the 50 MB L2;
//   fused_ks pass B, one block per (limb e, row tile): for j = 0..β-1 the
//     N2-point row NTTs of digit j's tile and the MAC with ksk[j, 0, e] and
//     ksk[j, 1, e] at the natural-order positions, both sums in registers, so
//     the TPU's sequential digit axis is a loop inside the block; out[e, 0]
//     and out[e, 1] are written once, as 64-byte segments;
//   fused_moddown pass A, one block per (row c·nq + e, column tile): the same
//     modup_pass_a over accumulator c's α P-block limbs to q_e, into a
//     (C, nq, N) scratch (7.3 MB at lstm C = 2);
//   fused_moddown pass B, one block per (row c·nq + e, row tile): the row
//     NTTs (row_ntt_pass) and out = (qpart − ŷ)·P^{-1}, qpart read and out
//     written in the same 64-byte segments as ŷ.
// At lstm (β = 2, m = 21, N = 2^16) fused_ks runs 672 blocks in pass A and
// 336 in pass B; fused_moddown runs 448 + 448 at C = 2 and 1792 + 1792 at
// C = 8, on 132 SMs.
//
// Bound on the H100: bytes.  fused_ks must read the digit limbs (nq·N
// words), the key (β·2·m·N) and write 2·m·N; it rereads each source limb
// once per extended limb from L2 and moves the scratch through L2 twice.  The
// NTTs cost ~N/2·log2(N) Montgomery multiplies per row, under the integer
// rate.  fused_moddown reads C·(α + nq) limbs and writes C·nq; it rereads the
// α source limbs once per q limb from L2, as fused_ks does.
#include <cuda_runtime.h>

#include <cstdint>

#include "bconv_core.cuh"
#include "ntt_passes.cuh"

namespace {

// Tables (uint32, Montgomery where marked):
//   d:        (nq, n)        coefficient-domain limbs of the polynomial to switch
//   ext_q/ext_qinv/ext_r2: (m,) moduli of the extended basis q_0..q_level, p_0..p_{alpha-1};
//                           source limb s < nq has modulus ext_q[s]
//   bh_m:     (nq,)          [B̂_s^{-1}]_{q_s}·R, B̂ taken within the digit of s
//   w_m:      (nq, m)        (B̂_s mod c_e)·R mod c_e
//   psi_m, roots_m, tw_m: (m, n)  forward twist, root powers and inter-pass
//                           twiddles (ntt_passes.cuh) of c_e, ·R
//   ksk:      (beta, 2, m, n) switching key, eval domain
//   scratch:  (beta, m, n)   pass A's output, pass B's input
//   out:      (m, 2, n)      the two accumulators
// Pass A: block (column tile, row j·m + e).
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    fused_ks_pass_a(const uint32_t* __restrict__ d, int nq, int alpha, const uint32_t* __restrict__ ext_q,
                    const uint32_t* __restrict__ ext_qinv, const uint32_t* __restrict__ bh_m,
                    const uint32_t* __restrict__ w_m, int m, const uint32_t* __restrict__ psi_m,
                    const uint32_t* __restrict__ roots_m, const uint32_t* __restrict__ tw_m,
                    uint32_t* __restrict__ scratch, int log_n) {
    digits_pass_a(d, nq, alpha, ext_q, ext_qinv, bh_m, w_m, m, psi_m, roots_m, tw_m, scratch, log_n);
}

// Pass B: block (row tile, extended limb e).
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    fused_ks_pass_b(const uint32_t* __restrict__ scratch, int beta, int m, const uint32_t* __restrict__ ext_q,
                    const uint32_t* __restrict__ ext_qinv, const uint32_t* __restrict__ ext_r2,
                    const uint32_t* __restrict__ roots_m, const uint32_t* __restrict__ ksk,
                    uint32_t* __restrict__ out, int log_n) {
    __shared__ uint32_t tile[PASS_TILE_WORDS];
    __shared__ uint32_t sub[1 << (PASS_MAX_LOG_M - 1)];
    const int log_n1 = pass_log_n1(log_n);
    const int log_n2 = log_n - log_n1;
    const int n = 1 << log_n;
    const int e = blockIdx.y;
    const uint32_t c = ext_q[e];
    const uint32_t cinv = ext_qinv[e];
    const uint32_t r2 = ext_r2[e];
    const int r0 = blockIdx.x * PASS_TILE;
    uint32_t* out0 = out + static_cast<size_t>(e) * 2 * n;
    uint32_t* out1 = out0 + n;
    uint32_t acc0[PASS_SLOTS];
    uint32_t acc1[PASS_SLOTS];
    load_sub_roots(sub, roots_m + static_cast<size_t>(e) * n, log_n2, log_n1);
    for (int j = 0; j < beta; ++j) {
        if (j > 0) __syncthreads();  // digit j-1's last stages have read the tile
        stage_rows(tile, scratch + (static_cast<size_t>(j) * m + e) * n, r0, log_n2);
        __syncthreads();
        const uint32_t* k0 = ksk + (static_cast<size_t>(2 * j) * m + e) * n;
        const uint32_t* k1 = ksk + (static_cast<size_t>(2 * j + 1) * m + e) * n;
        const bool last_digit = j == beta - 1;
        dif_columns(
            tile, 1, (1 << log_n2) + 1, log_n2, sub, c, cinv, staged_load(tile, log_n2),
            [&](int pos, int col, int slot, uint32_t v) {
                const size_t i = r0 + col + (static_cast<size_t>(rev_bits(pos, log_n2)) << log_n1);
                const uint32_t t0 = mulmod(v, k0[i], c, cinv, r2);
                const uint32_t t1 = mulmod(v, k1[i], c, cinv, r2);
                acc0[slot] = j == 0 ? t0 : addmod(acc0[slot], t0, c);
                acc1[slot] = j == 0 ? t1 : addmod(acc1[slot], t1, c);
                if (last_digit) {
                    out0[i] = acc0[slot];
                    out1[i] = acc1[slot];
                }
            });
    }
}

// ModDown tables (uint32, Montgomery where marked):
//   pc:       (C, alpha, n)  coefficient-domain P-block limbs
//   p_q/p_qinv/bh_m: (alpha,) special moduli and [P̂_i^{-1}]_{p_i}·R
//   w_m:      (alpha, nq)    (P̂_i mod q_e)·R mod q_e
//   q/qinv:   (nq,)          the q basis
//   psi_m, roots_m, tw_m: (nq, n)  forward NTT tables of q_e, ·R
//   scratch:  (C, nq, n)     pass A's output, pass B's input
//   qpart:    (C, nq, n)     eval-domain q limbs of the accumulators
//   pinv_m:   (nq,)          [P^{-1}]_{q_e}·R
//   out:      (C, nq, n)     (q_part − NTT(BConv(p))) · P^{-1}
// Pass A: block (column tile, row c·nq + e).  Held to two blocks per SM (64
// registers, as fused_ks_pass_a compiles to): left free, ptxas gives it 88,
// one 512-thread block fits on an SM, and at lstm it ran 0.068 ms against
// 0.060 at C = 2 and 0.227 against 0.200 at C = 8 (H100 80GB HBM3, 700 W).
__global__ void __launch_bounds__(PASS_MAX_THREADS, 2)
    fused_moddown_pass_a(const uint32_t* __restrict__ pc, int alpha, const uint32_t* __restrict__ p_q,
                         const uint32_t* __restrict__ p_qinv, const uint32_t* __restrict__ bh_m,
                         const uint32_t* __restrict__ w_m, int nq, const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ qinv, const uint32_t* __restrict__ psi_m,
                         const uint32_t* __restrict__ roots_m, const uint32_t* __restrict__ tw_m,
                         uint32_t* __restrict__ scratch, int log_n) {
    const int row = blockIdx.y;
    const int e = row % nq;
    const size_t at = static_cast<size_t>(e) << log_n;
    modup_pass_a(pc + (static_cast<size_t>(row / nq) * alpha << log_n), 0, alpha, bh_m, p_q, p_qinv, w_m, nq, e,
                 q[e], qinv[e], psi_m + at, roots_m + at, tw_m + at, scratch + (static_cast<size_t>(row) << log_n),
                 log_n);
}

// Pass B: block (row tile, row c·nq + e).
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    fused_moddown_pass_b(const uint32_t* __restrict__ scratch, int nq, const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ qinv, const uint32_t* __restrict__ roots_m,
                         const uint32_t* __restrict__ qpart, const uint32_t* __restrict__ pinv_m,
                         uint32_t* __restrict__ out, int log_n) {
    const int row = blockIdx.y;
    const int e = row % nq;
    const uint32_t qe = q[e];
    const uint32_t qi = qinv[e];
    const uint32_t pinv = pinv_m[e];
    const size_t at = static_cast<size_t>(row) << log_n;
    const uint32_t* qp = qpart + at;
    uint32_t* outr = out + at;
    row_ntt_pass(scratch + at, roots_m + (static_cast<size_t>(e) << log_n), qe, qi, log_n,
                 [&](size_t i, uint32_t v) { outr[i] = montmul(submod(qp[i], v, qe), pinv, qe, qi); });
}

}  // namespace

// scratch: (beta, m, n) words; n = 2^log_n with 8 <= log_n <= 16.
// Returns cudaGetLastError() after the launches.
extern "C" int fused_ks_launch(const void* d, int nq, int alpha, int beta, const void* ext_q, const void* ext_qinv,
                               const void* ext_r2, const void* bh_m, const void* w_m, int m, const void* psi_m,
                               const void* roots_m, const void* tw_m, const void* ksk, void* out, void* scratch, int n,
                               int log_n, void* stream) {
    if (!pass_size_ok(log_n) || n != (1 << log_n) || beta < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const PassGrids ga = pass_grids(beta * m, log_n);
    const PassGrids gb = pass_grids(m, log_n);
    fused_ks_pass_a<<<ga.grid1, ga.block1, 0, s>>>(
        static_cast<const uint32_t*>(d), nq, alpha, static_cast<const uint32_t*>(ext_q),
        static_cast<const uint32_t*>(ext_qinv), static_cast<const uint32_t*>(bh_m), static_cast<const uint32_t*>(w_m),
        m, static_cast<const uint32_t*>(psi_m), static_cast<const uint32_t*>(roots_m),
        static_cast<const uint32_t*>(tw_m), static_cast<uint32_t*>(scratch), log_n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_ks_pass_b<<<gb.grid2, gb.block2, 0, s>>>(
        static_cast<const uint32_t*>(scratch), beta, m, static_cast<const uint32_t*>(ext_q),
        static_cast<const uint32_t*>(ext_qinv), static_cast<const uint32_t*>(ext_r2),
        static_cast<const uint32_t*>(roots_m), static_cast<const uint32_t*>(ksk), static_cast<uint32_t*>(out), log_n);
    return static_cast<int>(cudaGetLastError());
}

// blocks[0], blocks[1]: the thread blocks fused_ks_launch starts for pass A and pass B.
extern "C" int fused_ks_blocks(int beta, int m, int log_n, int* blocks) {
    if (!pass_size_ok(log_n) || beta < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
    int b[2];
    pass_block_counts(pass_grids(beta * m, log_n), blocks);
    pass_block_counts(pass_grids(m, log_n), b);
    blocks[1] = b[1];
    return 0;
}

// scratch: (n_acc, nq, n) words, not overlapping out or qpart; n = 2^log_n
// with 8 <= log_n <= 16.  Returns cudaGetLastError() after the launches.
extern "C" int fused_moddown_launch(const void* pc, int n_acc, int alpha, const void* p_q, const void* p_qinv,
                                    const void* bh_m, const void* w_m, int nq, const void* q, const void* qinv,
                                    const void* psi_m, const void* roots_m, const void* tw_m, const void* qpart,
                                    const void* pinv_m, void* out, void* scratch, int n, int log_n, void* stream) {
    if (!pass_size_ok(log_n) || n != (1 << log_n) || n_acc < 1 || nq < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    const PassGrids g = pass_grids(n_acc * nq, log_n);
    fused_moddown_pass_a<<<g.grid1, g.block1, 0, s>>>(
        static_cast<const uint32_t*>(pc), alpha, static_cast<const uint32_t*>(p_q),
        static_cast<const uint32_t*>(p_qinv), static_cast<const uint32_t*>(bh_m), static_cast<const uint32_t*>(w_m),
        nq, static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qinv), static_cast<const uint32_t*>(psi_m),
        static_cast<const uint32_t*>(roots_m), static_cast<const uint32_t*>(tw_m), static_cast<uint32_t*>(scratch),
        log_n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_moddown_pass_b<<<g.grid2, g.block2, 0, s>>>(
        static_cast<const uint32_t*>(scratch), nq, static_cast<const uint32_t*>(q),
        static_cast<const uint32_t*>(qinv), static_cast<const uint32_t*>(roots_m), static_cast<const uint32_t*>(qpart),
        static_cast<const uint32_t*>(pinv_m), static_cast<uint32_t*>(out), log_n);
    return static_cast<int>(cudaGetLastError());
}

// blocks[0], blocks[1]: the thread blocks fused_moddown_launch starts for pass A and pass B.
extern "C" int fused_moddown_blocks(int n_acc, int nq, int log_n, int* blocks) {
    if (!pass_size_ok(log_n) || n_acc < 1 || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
    pass_block_counts(pass_grids(n_acc * nq, log_n), blocks);
    return 0;
}
