// Hoisted (Halevi–Shoup) rotation key-switching: the shared ModUp of a
// rotation group, and the batched Galois key MAC.
//
// Replaces the Pallas kernels hoist_modup_pallas and hoist_mac_pallas
// (src/repro/kernels/hoistrot/kernel.py:56, 111).
//
// hoist_modup is fused_ks (fusedks.cu) without the MAC: for each (digit j,
// extended limb e) it prescales the digit's source limbs, converts them to
// c_e, twists and runs the forward NTT (modup_row of bconv_core.cuh, the copy
// fused_ks runs), and writes the result to out[j, e] of a (β, m, n) tensor.
// The TPU swept the digits as a sequential grid axis; here every (j, e) is a
// block of its own, β·m blocks (42 at lstm against fused_ks's 21), since no
// digit depends on another.  The working limb lives in shared memory for
// n <= 2^15 and, at n = 2^16, in the block's own output row, which stays in
// L2 between the butterfly stages.
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
// twiddle tables) and bytes at lola_mnist_plain, but its n/2·log2(n)
// butterflies per block run on one SM each, so occupancy (β·m blocks on 132
// SMs) is what holds it back, as it holds fused_ks.  hoist_mac: bytes.  It streams R·β·2 key limbs per output
// limb pair and does 2 montmuls and an add per key word: ~19 integer
// operations against 4 bytes, well under the card's ratio of operations to
// bytes.  hoist_mac is instantiated for β = 1..MAX_BETA, the digit counts the
// presets reach (dnum <= 4); hoist_mac_max_beta() reports the limit.
#include <cuda_runtime.h>

#include <cstdint>

#include "bconv_core.cuh"
#include "ntt_core.cuh"

namespace {

constexpr int MAC_THREADS = 256;
constexpr int MAX_BETA = 4;

// One block per (digit j, extended limb e), block index j·m + e.  Tables as
// fused_ks_kernel's (fusedks.cu):
//   d:        (nq, n)   coefficient-domain limbs of the polynomial
//   ext_q/ext_qinv: (m,) extended basis; source limb s < nq has modulus ext_q[s]
//   bh_m:     (nq,)     [B̂_s^{-1}]·R, B̂ taken within the digit of s
//   w_m:      (nq, m)   (B̂_s mod c_e)·R mod c_e
//   psi_m, roots_m: (m, n) forward twist and root powers of c_e, ·R
//   out:      (beta, m, n)
__global__ void __launch_bounds__(NTT_THREADS)
    hoist_modup_kernel(const uint32_t* __restrict__ d, int nq, int alpha, const uint32_t* __restrict__ ext_q,
                       const uint32_t* __restrict__ ext_qinv, const uint32_t* __restrict__ bh_m,
                       const uint32_t* __restrict__ w_m, int m, const uint32_t* __restrict__ psi_m,
                       const uint32_t* __restrict__ roots_m, uint32_t* out, int n, int log_n, int in_global) {
    const int j = blockIdx.x / m;
    const int e = blockIdx.x % m;
    const uint32_t c = ext_q[e];
    const uint32_t cinv = ext_qinv[e];
    const int lo = j * alpha;
    const int hi = min(lo + alpha, nq);
    uint32_t* outr = out + static_cast<size_t>(blockIdx.x) * n;
    uint32_t* buf = ntt_buffer(in_global ? outr : nullptr);
    modup_row(buf, d, n, log_n, lo, hi, bh_m, ext_q, ext_qinv, w_m, m, e, c, cinv, psi_m, roots_m);
    if (!in_global) {
        for (int i = threadIdx.x; i < n; i += blockDim.x) outr[i] = buf[i];
    }
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

// Returns cudaGetLastError() after the launch.
extern "C" int hoist_modup_launch(const void* d, int nq, int alpha, int beta, const void* ext_q, const void* ext_qinv,
                                  const void* bh_m, const void* w_m, int m, const void* psi_m, const void* roots_m,
                                  void* out, int n, int log_n, void* stream) {
    const int smem = ntt_smem_bytes(n);
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(hoist_modup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    hoist_modup_kernel<<<beta * m, NTT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(d), nq, alpha, static_cast<const uint32_t*>(ext_q),
        static_cast<const uint32_t*>(ext_qinv), static_cast<const uint32_t*>(bh_m), static_cast<const uint32_t*>(w_m),
        m, static_cast<const uint32_t*>(psi_m), static_cast<const uint32_t*>(roots_m), static_cast<uint32_t*>(out), n,
        log_n, smem == 0 ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int hoist_mac_max_beta() { return MAX_BETA; }

// 1 <= beta <= MAX_BETA (else cudaErrorInvalidValue, nothing launched).
// Returns cudaGetLastError() after the launch.
extern "C" int hoist_mac_launch(const void* dig, const void* ksk, int beta, int nrot, int m, const void* q,
                                const void* qinv, const void* r2, void* out, int n, void* stream) {
    return launch_mac<MAX_BETA>(beta, dig, ksk, nrot, m, q, qinv, r2, out, n, static_cast<cudaStream_t>(stream));
}
