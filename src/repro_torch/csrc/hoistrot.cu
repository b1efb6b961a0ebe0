// Hoisted (Halevi–Shoup) rotation key-switching: the shared ModUp of a
// rotation group, and the batched Galois key MAC.
//
// Replaces the Pallas kernels hoist_modup_pallas and hoist_mac_pallas
// (src/repro/kernels/hoistrot/kernel.py:56, 111).
//
// hoist_modup is fused_ks (fusedks.cu) without the MAC: for each (digit j,
// extended limb e) it prescales the digit's source limbs, converts them to
// c_e, twists and runs the forward NTT, and writes the result to out[j, e] of
// a (β, m, n) tensor.  The TPU swept the digits as a sequential grid axis;
// here no digit depends on another, and the two passes of ntt_passes.cuh
// spread every (j, e) row over many blocks: pass A is fused_ks's
// (digits_pass_a of bconv_core.cuh, one block per (row, column tile)) into a
// (β, m, n) scratch, 11 MiB at lstm, which stays in the 50 MB L2; pass B is
// the forward NTT's pass 2 (row_ntt_pass), one block per (row, row tile),
// storing to out.  At lstm (β = 2, m = 21, n = 2^16) that is 672 + 672
// blocks on 132 SMs.
//
// hoist_mac is out[r, c, e, i] = Σ_j dig[j, e, i]·ksk[r, j, c, e, i] mod q_e,
// each product by two montmuls (·ksk, then ·R²) exactly as the TPU's
// _mac_body does.  The TPU kept the (β, n) digit block of limb e resident in
// VMEM while the rotation axis r swept; here each thread loads its β digit
// words into registers once and loops over every rotation and both key
// components, so the digits are read from device memory once per group.
//
// Bound on the H100: hoist_modup, operations at lstm (≈ 0.55 G integer
// operations, most of them the β·m NTTs, against ≈ 26 MB of traffic with the
// twiddle tables) and bytes at lola_mnist_plain; like fused_ks it rereads
// each source limb once per extended limb from L2.  hoist_mac: bytes.  It
// streams R·β·2 key limbs per output limb pair and does 2 montmuls and an add
// per key word: ~19 integer operations against 4 bytes, well under the card's
// ratio of operations to bytes.  hoist_mac is instantiated for β = 1..MAX_BETA,
// the digit counts the presets reach (dnum <= 4); hoist_mac_max_beta()
// reports the limit.
#include <cuda_runtime.h>

#include <cstdint>

#include "bconv_core.cuh"
#include "ntt_passes.cuh"

namespace {

constexpr int MAC_THREADS = 256;
constexpr int MAX_BETA = 4;

// Tables as fused_ks's (fusedks.cu):
//   d:        (nq, n)   coefficient-domain limbs of the polynomial
//   ext_q/ext_qinv: (m,) extended basis; source limb s < nq has modulus ext_q[s]
//   bh_m:     (nq,)     [B̂_s^{-1}]·R, B̂ taken within the digit of s
//   w_m:      (nq, m)   (B̂_s mod c_e)·R mod c_e
//   psi_m, roots_m, tw_m: (m, n) forward twist, root powers and inter-pass twiddles of c_e, ·R
//   scratch, out: (beta, m, n)
// Pass A: block (column tile, row j·m + e).
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    hoist_modup_pass_a(const uint32_t* __restrict__ d, int nq, int alpha, const uint32_t* __restrict__ ext_q,
                       const uint32_t* __restrict__ ext_qinv, const uint32_t* __restrict__ bh_m,
                       const uint32_t* __restrict__ w_m, int m, const uint32_t* __restrict__ psi_m,
                       const uint32_t* __restrict__ roots_m, const uint32_t* __restrict__ tw_m,
                       uint32_t* __restrict__ scratch, int log_n) {
    digits_pass_a(d, nq, alpha, ext_q, ext_qinv, bh_m, w_m, m, psi_m, roots_m, tw_m, scratch, log_n);
}

// Pass B: block (row tile, row j·m + e).
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    hoist_modup_pass_b(const uint32_t* __restrict__ scratch, int m, const uint32_t* __restrict__ ext_q,
                       const uint32_t* __restrict__ ext_qinv, const uint32_t* __restrict__ roots_m,
                       uint32_t* __restrict__ out, int log_n) {
    const int e = blockIdx.y % m;
    const size_t at = static_cast<size_t>(blockIdx.y) << log_n;
    uint32_t* outr = out + at;
    row_ntt_pass(scratch + at, roots_m + (static_cast<size_t>(e) << log_n), ext_q[e], ext_qinv[e], log_n,
                 [&](size_t i, uint32_t v) { outr[i] = v; });
}

// One thread per (extended limb e, coefficient i); grid (n / MAC_THREADS, m).
//   dig:  (BETA, m, n)        hoisted digits, eval domain
//   ksk:  (nrot, BETA, 2, m, n) σ_t^{-1}-pre-permuted key limbs
//   q/qinv/r2: (m,)           extended basis and its Montgomery constants
//   out:  (nrot, 2, m, n)
template <int BETA>
__global__ void __launch_bounds__(MAC_THREADS)
    hoist_mac_kernel(const uint32_t* __restrict__ dig, const uint32_t* __restrict__ ksk, int nrot, int m,
                     const uint32_t* __restrict__ q, const uint32_t* __restrict__ qinv,
                     const uint32_t* __restrict__ r2, uint32_t* __restrict__ out, int n) {
    const int e = blockIdx.y;
    const size_t i = static_cast<size_t>(blockIdx.x) * MAC_THREADS + threadIdx.x;
    if (i >= static_cast<size_t>(n)) return;
    const uint32_t qe = q[e];
    const uint32_t qi = qinv[e];
    const uint32_t r2e = r2[e];
    const size_t limb = static_cast<size_t>(m) * n;  // stride of one (m, n) block
    const size_t at = static_cast<size_t>(e) * n + i;
    uint32_t x[BETA];
#pragma unroll
    for (int j = 0; j < BETA; ++j) x[j] = dig[j * limb + at];
    for (int r = 0; r < nrot; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            uint32_t acc = 0;
#pragma unroll
            for (int j = 0; j < BETA; ++j) {
                const uint32_t t = mulmod(x[j], ksk[((static_cast<size_t>(r) * BETA + j) * 2 + c) * limb + at], qe,
                                          qi, r2e);
                acc = j == 0 ? t : addmod(acc, t, qe);
            }
            out[(static_cast<size_t>(r) * 2 + c) * limb + at] = acc;
        }
    }
}

// Launches hoist_mac_kernel<beta> for 1 <= beta <= BETA; cudaErrorInvalidValue otherwise.
template <int BETA>
int launch_mac(int beta, const void* dig, const void* ksk, int nrot, int m, const void* q, const void* qinv,
               const void* r2, void* out, int n, cudaStream_t stream) {
    if constexpr (BETA == 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (beta != BETA) return launch_mac<BETA - 1>(beta, dig, ksk, nrot, m, q, qinv, r2, out, n, stream);
        const dim3 grid((n + MAC_THREADS - 1) / MAC_THREADS, m);
        hoist_mac_kernel<BETA><<<grid, MAC_THREADS, 0, stream>>>(
            static_cast<const uint32_t*>(dig), static_cast<const uint32_t*>(ksk), nrot, m,
            static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qinv), static_cast<const uint32_t*>(r2),
            static_cast<uint32_t*>(out), n);
        return static_cast<int>(cudaGetLastError());
    }
}

}  // namespace

// scratch: (beta, m, n) words, not overlapping out; n = 2^log_n with
// 8 <= log_n <= 16.  Returns cudaGetLastError() after the launches.
extern "C" int hoist_modup_launch(const void* d, int nq, int alpha, int beta, const void* ext_q, const void* ext_qinv,
                                  const void* bh_m, const void* w_m, int m, const void* psi_m, const void* roots_m,
                                  const void* tw_m, void* out, void* scratch, int n, int log_n, void* stream) {
    if (!pass_size_ok(log_n) || n != (1 << log_n) || beta < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const PassGrids g = pass_grids(beta * m, log_n);
    hoist_modup_pass_a<<<g.grid1, g.block1, 0, s>>>(
        static_cast<const uint32_t*>(d), nq, alpha, static_cast<const uint32_t*>(ext_q),
        static_cast<const uint32_t*>(ext_qinv), static_cast<const uint32_t*>(bh_m), static_cast<const uint32_t*>(w_m),
        m, static_cast<const uint32_t*>(psi_m), static_cast<const uint32_t*>(roots_m),
        static_cast<const uint32_t*>(tw_m), static_cast<uint32_t*>(scratch), log_n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    hoist_modup_pass_b<<<g.grid2, g.block2, 0, s>>>(
        static_cast<const uint32_t*>(scratch), m, static_cast<const uint32_t*>(ext_q),
        static_cast<const uint32_t*>(ext_qinv), static_cast<const uint32_t*>(roots_m), static_cast<uint32_t*>(out),
        log_n);
    return static_cast<int>(cudaGetLastError());
}

// blocks[0], blocks[1]: the thread blocks hoist_modup_launch starts for pass A and pass B.
extern "C" int hoist_modup_blocks(int beta, int m, int log_n, int* blocks) {
    if (!pass_size_ok(log_n) || beta < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
    pass_block_counts(pass_grids(beta * m, log_n), blocks);
    return 0;
}

extern "C" int hoist_mac_max_beta() { return MAX_BETA; }

// 1 <= beta <= MAX_BETA (else cudaErrorInvalidValue, nothing launched).
// Returns cudaGetLastError() after the launch.
extern "C" int hoist_mac_launch(const void* dig, const void* ksk, int beta, int nrot, int m, const void* q,
                                const void* qinv, const void* r2, void* out, int n, void* stream) {
    return launch_mac<MAX_BETA>(beta, dig, ksk, nrot, m, q, qinv, r2, out, n, static_cast<cudaStream_t>(stream));
}
