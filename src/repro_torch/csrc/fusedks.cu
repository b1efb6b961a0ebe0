// The fused key-switch pipeline: prescale -> BConv -> NTT -> key MAC in one
// launch, and the fused ModDown tail in a second.
//
// Replaces the Pallas kernels fused_ks_pallas and fused_moddown_pallas
// (src/repro/kernels/fusedks/kernel.py:121, 178).  On the TPU the digit axis j
// was the innermost sequential grid axis, accumulating through
// pl.when(j == 0); blocks on Hopper run in no order, so here each block owns
// one output limb and loops over the digits itself.  BConv is the shared
// modup_row of bconv_core.cuh, which reduces every x̂_i·W[i, e] term mod
// c_e before adding (the rule of src/repro/kernels/bconv/ref.py:28).  The TPU's 8-bit-limb MXU dots and its
// zero-padded digit rows with the dummy modulus 3 have no place here: each
// digit loops over its own limb count.  The NTT is the device function of
// ntt.cu (ntt_core.cuh), so both kernels hold the working limb in shared
// memory for N <= 2^15 and in a global row of their own for N = 2^16.
//
// Bound on the H100: bytes.  fused_ks reads the digit limbs once per output
// limb (m·k·N words through L2), the key (β·2·m·N words) and writes 2·m·N;
// fused_moddown reads α + 1 limbs and writes one per block.  The NTT in the
// middle costs ~N/2·log2(N) Montgomery multiplies per limb, well under the
// integer rate.  The design keeps every intermediate of a digit out of device
// memory below N = 2^16 and in L2 at it.  The grid is m blocks (4 at matmul,
// 21 at lstm) for fused_ks and C·(level+1) for fused_moddown, on 132 SMs:
// occupancy, not arithmetic, is what holds these kernels back.
#include <cuda_runtime.h>

#include <cstdint>

#include "bconv_core.cuh"
#include "ntt_core.cuh"

namespace {

// One block per extended limb e.  Tables (uint32, Montgomery where marked):
//   d:        (nq, n)        coefficient-domain limbs of the polynomial to switch
//   ext_q/ext_qinv/ext_r2: (m,) moduli of the extended basis q_0..q_level, p_0..p_{alpha-1};
//                           source limb s < nq has modulus ext_q[s]
//   bh_m:     (nq,)          [B̂_s^{-1}]_{q_s}·R, B̂ taken within the digit of s
//   w_m:      (nq, m)        (B̂_s mod c_e)·R mod c_e
//   psi_m, roots_m: (m, n)   forward twist and root powers of c_e, ·R
//   ksk:      (beta, 2, m, n) switching key, eval domain
//   out:      (m, 2, n)      the two accumulators
//   scratch:  (m, n) or null (then the limb lives in shared memory)
__global__ void __launch_bounds__(NTT_THREADS)
    fused_ks_kernel(const uint32_t* __restrict__ d, int nq, int alpha, int beta, const uint32_t* __restrict__ ext_q,
                    const uint32_t* __restrict__ ext_qinv, const uint32_t* __restrict__ ext_r2,
                    const uint32_t* __restrict__ bh_m, const uint32_t* __restrict__ w_m, int m,
                    const uint32_t* __restrict__ psi_m, const uint32_t* __restrict__ roots_m,
                    const uint32_t* __restrict__ ksk, uint32_t* __restrict__ out, uint32_t* scratch, int n,
                    int log_n) {
    const int e = blockIdx.x;
    const uint32_t c = ext_q[e];
    const uint32_t cinv = ext_qinv[e];
    const uint32_t r2 = ext_r2[e];
    uint32_t* buf = ntt_buffer(scratch != nullptr ? scratch + static_cast<size_t>(e) * n : nullptr);
    uint32_t* acc0 = out + static_cast<size_t>(e) * 2 * n;
    uint32_t* acc1 = acc0 + n;

    for (int j = 0; j < beta; ++j) {
        const int lo = j * alpha;
        const int hi = min(lo + alpha, nq);
        modup_row(buf, d, n, log_n, lo, hi, bh_m, ext_q, ext_qinv, w_m, m, e, c, cinv, psi_m, roots_m);
        // key MAC into both accumulators
        const uint32_t* k0 = ksk + (static_cast<size_t>(2 * j) * m + e) * n;
        const uint32_t* k1 = ksk + (static_cast<size_t>(2 * j + 1) * m + e) * n;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const uint32_t yh = buf[i];
            const uint32_t t0 = mulmod(yh, k0[i], c, cinv, r2);
            const uint32_t t1 = mulmod(yh, k1[i], c, cinv, r2);
            acc0[i] = j == 0 ? t0 : addmod(acc0[i], t0, c);
            acc1[i] = j == 0 ? t1 : addmod(acc1[i], t1, c);
        }
        __syncthreads();  // the next digit overwrites buf
    }
}

// One block per (accumulator c, q limb e), block index c·nq + e.
//   pc:       (C, alpha, n)  coefficient-domain P-block limbs
//   p_q/p_qinv/bh_m: (alpha,) special moduli and [P̂_i^{-1}]_{p_i}·R
//   w_m:      (alpha, nq)    (P̂_i mod q_e)·R mod q_e
//   q/qinv:   (nq,)          the q basis
//   psi_m, roots_m: (nq, n)  forward NTT tables of q_e, ·R
//   qpart:    (C, nq, n)     eval-domain q limbs of the accumulators
//   pinv_m:   (nq,)          [P^{-1}]_{q_e}·R
//   out:      (C, nq, n)     (q_part − NTT(BConv(p))) · P^{-1}
__global__ void __launch_bounds__(NTT_THREADS)
    fused_moddown_kernel(const uint32_t* __restrict__ pc, int alpha, const uint32_t* __restrict__ p_q,
                         const uint32_t* __restrict__ p_qinv, const uint32_t* __restrict__ bh_m,
                         const uint32_t* __restrict__ w_m, int nq, const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ qinv, const uint32_t* __restrict__ psi_m,
                         const uint32_t* __restrict__ roots_m, const uint32_t* __restrict__ qpart,
                         const uint32_t* __restrict__ pinv_m, uint32_t* out, int n, int log_n, int in_global) {
    const int cb = blockIdx.x / nq;
    const int e = blockIdx.x % nq;
    const uint32_t qe = q[e];
    const uint32_t qi = qinv[e];
    const uint32_t* src = pc + static_cast<size_t>(cb) * alpha * n;
    const uint32_t* qp = qpart + (static_cast<size_t>(cb) * nq + e) * n;
    uint32_t* outr = out + (static_cast<size_t>(cb) * nq + e) * n;
    uint32_t* buf = ntt_buffer(in_global ? outr : nullptr);

    modup_row(buf, src, n, log_n, 0, alpha, bh_m, p_q, p_qinv, w_m, nq, e, qe, qi, psi_m, roots_m);
    const uint32_t pinv = pinv_m[e];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        outr[i] = montmul(submod(qp[i], buf[i], qe), pinv, qe, qi);
    }
}

int set_smem(const void* kernel, int smem) {
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

// scratch: (m, n) words, used only when n > SMEM_MAX_N.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_ks_launch(const void* d, int nq, int alpha, int beta, const void* ext_q, const void* ext_qinv,
                               const void* ext_r2, const void* bh_m, const void* w_m, int m, const void* psi_m,
                               const void* roots_m, const void* ksk, void* out, void* scratch, int n, int log_n,
                               void* stream) {
    const int smem = ntt_smem_bytes(n);
    if (const int err = set_smem(reinterpret_cast<const void*>(fused_ks_kernel), smem)) return err;
    fused_ks_kernel<<<m, NTT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(d), nq, alpha, beta, static_cast<const uint32_t*>(ext_q),
        static_cast<const uint32_t*>(ext_qinv), static_cast<const uint32_t*>(ext_r2),
        static_cast<const uint32_t*>(bh_m), static_cast<const uint32_t*>(w_m), m,
        static_cast<const uint32_t*>(psi_m), static_cast<const uint32_t*>(roots_m),
        static_cast<const uint32_t*>(ksk), static_cast<uint32_t*>(out),
        smem == 0 ? static_cast<uint32_t*>(scratch) : nullptr, n, log_n);
    return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError() after the launch.
extern "C" int fused_moddown_launch(const void* pc, int n_acc, int alpha, const void* p_q, const void* p_qinv,
                                    const void* bh_m, const void* w_m, int nq, const void* q, const void* qinv,
                                    const void* psi_m, const void* roots_m, const void* qpart, const void* pinv_m,
                                    void* out, int n, int log_n, void* stream) {
    const int smem = ntt_smem_bytes(n);
    if (const int err = set_smem(reinterpret_cast<const void*>(fused_moddown_kernel), smem)) return err;
    fused_moddown_kernel<<<n_acc * nq, NTT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pc), alpha, static_cast<const uint32_t*>(p_q),
        static_cast<const uint32_t*>(p_qinv), static_cast<const uint32_t*>(bh_m), static_cast<const uint32_t*>(w_m),
        nq, static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qinv),
        static_cast<const uint32_t*>(psi_m), static_cast<const uint32_t*>(roots_m),
        static_cast<const uint32_t*>(qpart), static_cast<const uint32_t*>(pinv_m), static_cast<uint32_t*>(out), n,
        log_n, smem == 0 ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}
