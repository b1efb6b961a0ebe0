// Forward and inverse negacyclic NTT, one thread block per (batch, limb) row.
//
// Replaces the Pallas kernel ntt_pallas (src/repro/kernels/ntt/kernel.py:104).
// That kernel is four-step, with the row and column NTTs as 8-bit-limb int32
// matmuls on the TPU's MXU; nothing here carries that over.  This is the
// radix-2 decimation-in-time NTT of ntt_core.cuh:
//   forward: buf[bitrev(i)] = x[i]·psi^i;  stages over w;          out = buf
//   inverse: buf[bitrev(i)] = x[i];        stages over w^{-1};     out[i] = buf[i]·psi^{-i}·N^{-1}
// Slot j of the forward output is a(psi^(2j+1)), natural order, as in the reference.
//
// Bound on the H100: bytes at the main path's sizes (one N = 2^16 limb does
// 16·2^15 butterflies, ~0.5 M Montgomery multiplies, against 512 KiB moved).
// The design: N <= 2^15 works in shared memory, so device memory sees one
// read and one write per coefficient.  N = 2^16 does not fit in a block's
// 227 KB, so its block works in place in its own output row, which stays in
// L2 between the 16 stages.  One block per row leaves most of the 132 SMs idle
// for a single ciphertext (14 rows at lstm's top level): occupancy is the
// first thing a faster version has to fix.
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_core.cuh"

namespace {

// x, out: (rows, n).  Row r uses limb r % limbs of the tables:
//   twist_m = psi^i·R (forward) or psi^{-i}·N^{-1}·R (inverse);  roots_m = w^i·R or w^{-i}·R.
template <bool INVERSE>
__global__ void __launch_bounds__(NTT_THREADS) ntt_kernel(const uint32_t* __restrict__ x, uint32_t* out,
                                                          const uint32_t* __restrict__ q,
                                                          const uint32_t* __restrict__ qinv,
                                                          const uint32_t* __restrict__ twist_m,
                                                          const uint32_t* __restrict__ roots_m, int limbs,
                                                          int n, int log_n, int in_global) {
    const size_t row = blockIdx.x;
    const int limb = static_cast<int>(row % limbs);
    const uint32_t qq = q[limb];
    const uint32_t qi = qinv[limb];
    const uint32_t* xr = x + row * n;
    uint32_t* outr = out + row * n;
    const uint32_t* tw = twist_m + static_cast<size_t>(limb) * n;
    uint32_t* buf = ntt_buffer(in_global ? outr : nullptr);

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint32_t v = INVERSE ? xr[i] : montmul(xr[i], tw[i], qq, qi);
        buf[bitrev(i, log_n)] = v;
    }
    ntt_dit_stages(buf, roots_m + static_cast<size_t>(limb) * n, n, log_n, qq, qi);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        outr[i] = INVERSE ? montmul(buf[i], tw[i], qq, qi) : buf[i];
    }
}

template <bool INVERSE>
int launch(const void* x, void* out, const void* q, const void* qinv, const void* twist_m, const void* roots_m,
           int rows, int limbs, int n, int log_n, cudaStream_t stream) {
    const int smem = ntt_smem_bytes(n);
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(ntt_kernel<INVERSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    ntt_kernel<INVERSE><<<rows, NTT_THREADS, smem, stream>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), static_cast<const uint32_t*>(q),
        static_cast<const uint32_t*>(qinv), static_cast<const uint32_t*>(twist_m),
        static_cast<const uint32_t*>(roots_m), limbs, n, log_n, smem == 0 ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out must not overlap.  Returns cudaGetLastError() after the launch.
extern "C" int ntt_launch(int inverse, const void* x, void* out, const void* q, const void* qinv,
                          const void* twist_m, const void* roots_m, int rows, int limbs, int n, int log_n,
                          void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (inverse) return launch<true>(x, out, q, qinv, twist_m, roots_m, rows, limbs, n, log_n, s);
    return launch<false>(x, out, q, qinv, twist_m, roots_m, rows, limbs, n, log_n, s);
}
