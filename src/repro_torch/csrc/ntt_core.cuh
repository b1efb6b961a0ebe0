// Block-wide radix-2 NTT of one limb: the NTT inside modup_row
// (bconv_core.cuh), which fused_moddown (fusedks.cu) and hoist_modup
// (hoistrot.cu) run.  The standalone NTT and fused_ks no longer use it: they
// run the two-pass NTT of ntt_passes.cuh, many blocks per limb.
//
// Bound on the H100: one block's latency, not bytes or operations.  One
// thread block owns one limb of N coefficients in `buf`, which is either
// dynamic shared memory (N <= SMEM_MAX_N) or a global-memory row that only
// this block touches (N = 2^16: 256 KiB is more than the 227 KB of shared
// memory a block can have, and the row stays in the 50 MB L2 between stages).
// __syncthreads() orders the stages for both: it makes the block's global and
// shared writes visible to the whole block.
//
// The algorithm is the iterative decimation-in-time NTT of
// src/repro/kernels/ntt/ref.py:26-58: write the (twisted) input to its
// bit-reversed slot, then log2(N) butterfly stages over the cyclic root w.
// Twiddle tables are in Montgomery form (x·R mod q), so one montmul applies
// each.  Every result is canonical in [0, q), so the output is bit-identical
// to any other exact NTT of the same input.
#pragma once

#include <cstdint>

#include "montgomery.cuh"

constexpr int NTT_THREADS = 1024;
constexpr int SMEM_MAX_N = 1 << 15;  // 128 KiB of dynamic shared memory

// Slot of coefficient i after the bit-reversal permutation (log_n >= 1).
__device__ __forceinline__ int bitrev(int i, int log_n) {
    return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log_n));
}

// The log2(N) butterfly stages over buf, which already holds the input in
// bit-reversed order.  Starts and ends with a barrier, so callers may write
// buf right before and read it right after.
__device__ __forceinline__ void ntt_dit_stages(uint32_t* buf, const uint32_t* __restrict__ roots_m,
                                               int n, int log_n, uint32_t q, uint32_t qinv) {
    const int half = n >> 1;
    for (int log_m = 0; log_m < log_n; ++log_m) {
        __syncthreads();
        const int m = 1 << log_m;
        const int step = log_n - 1 - log_m;  // twiddle j of this stage is w^(j·N/2m)
        for (int t = threadIdx.x; t < half; t += blockDim.x) {
            const int j = t & (m - 1);
            const int i0 = ((t >> log_m) << (log_m + 1)) + j;
            const int i1 = i0 + m;
            const uint32_t even = buf[i0];
            const uint32_t odd = montmul(buf[i1], roots_m[j << step], q, qinv);
            buf[i0] = addmod(even, odd, q);
            buf[i1] = submod(even, odd, q);
        }
    }
    __syncthreads();
}

extern __shared__ uint32_t ntt_smem[];

// Where the block's working limb lives: shared memory, or its own global row.
__device__ __forceinline__ uint32_t* ntt_buffer(uint32_t* global_row) {
    return global_row != nullptr ? global_row : ntt_smem;
}

// Host side: the dynamic shared memory a launch needs for one limb of n.
inline int ntt_smem_bytes(int n) { return n <= SMEM_MAX_N ? n * 4 : 0; }
