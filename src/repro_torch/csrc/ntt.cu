// Forward and inverse negacyclic NTT: one C entry, two kernels, many thread
// blocks per limb.
//
// Replaces the Pallas kernel ntt_pallas (src/repro/kernels/ntt/kernel.py:104).
// That kernel is four-step too, with the row and column NTTs as 8-bit-limb
// int32 matmuls on the TPU's MXU; here the sub-NTTs are integer butterflies
// (ntt_passes.cuh says why the tensor cores are not the tool).
//   forward: pass 1 loads x[i]·psi^i, pass 2 stores X in natural order;
//   inverse: the same passes over w^-1, and pass 2 stores X[i]·psi^-i·N^-1.
// Slot j of the forward output is a(psi^(2j+1)), natural order, as in the reference.
//
// Bound on the H100: bytes (one N = 2^16 limb does 16·2^15 butterflies,
// ~0.5 M Montgomery multiplies, against 512 KiB read and written).  Each pass
// moves every limb once: pass 1 reads x (and the twist and the inter-pass
// twiddles) and writes the intermediate Y into the caller's scratch, which at
// the main path's sizes (3.7 MB at lstm's 14 limbs) stays in the 50 MB L2
// for pass 2.  The grid is rows·N2/16 blocks for pass 1 and rows·N1/16 for
// pass 2 (224 each for 14 limbs of 2^16, 16 for one), where the earlier
// design ran one block per limb through all 16 stages in L2.
//
// ntt_launch starts both kernels on the caller's stream, so one dispatch
// counts one launch; a profiler shows two kernel names (ntt_pass1, ntt_pass2)
// per call.
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_passes.cuh"

namespace {

// x, y: (rows, n).  Row r uses limb r % limbs of the tables (each (limbs, n), ·R):
//   twist_m: psi^i (forward) or psi^-i·N^-1 (inverse);  roots_m: w^i or w^-i;
//   tw_m: the inter-pass twiddles, tw_m[k1·N2 + n2] = w^(k1·n2) or w^-(k1·n2).
template <bool INVERSE>
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    ntt_pass1(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, const uint32_t* __restrict__ q,
              const uint32_t* __restrict__ qinv, const uint32_t* __restrict__ twist_m,
              const uint32_t* __restrict__ roots_m, const uint32_t* __restrict__ tw_m, int limbs, int log_n) {
    __shared__ uint32_t tile[PASS_TILE_WORDS];
    __shared__ uint32_t sub[1 << (PASS_MAX_LOG_M - 1)];
    const int log_n1 = pass_log_n1(log_n);
    const int log_n2 = log_n - log_n1;
    const size_t row = blockIdx.y;
    const int limb = static_cast<int>(row % limbs);
    const size_t n = size_t{1} << log_n;
    const uint32_t qq = q[limb];
    const uint32_t qi = qinv[limb];
    const uint32_t* xr = x + row * n;
    uint32_t* yr = y + row * n;
    const uint32_t* twist = twist_m + limb * n;
    const uint32_t* tw = tw_m + limb * n;
    const int c0 = blockIdx.x * PASS_TILE;
    load_sub_roots(sub, roots_m + limb * n, log_n1, log_n2);
    __syncthreads();
    dif_columns(
        tile, PASS_TILE, 1, log_n1, sub, qq, qi,
        [&](const int* pos, int col, uint32_t* v) {
#pragma unroll
            for (int x = 0; x < PASS_SLOTS; ++x) {
                const size_t i = (static_cast<size_t>(pos[x]) << log_n2) + c0 + col;
                v[x] = INVERSE ? xr[i] : montmul(xr[i], twist[i], qq, qi);
            }
        },
        [&](int pos, int col, int, uint32_t v) {
            const size_t i = (static_cast<size_t>(rev_bits(pos, log_n1)) << log_n2) + c0 + col;
            yr[i] = montmul(v, tw[i], qq, qi);
        });
}

template <bool INVERSE>
__global__ void __launch_bounds__(PASS_MAX_THREADS)
    ntt_pass2(const uint32_t* __restrict__ y, uint32_t* __restrict__ out, const uint32_t* __restrict__ q,
              const uint32_t* __restrict__ qinv, const uint32_t* __restrict__ twist_m,
              const uint32_t* __restrict__ roots_m, int limbs, int log_n) {
    const size_t row = blockIdx.y;
    const int limb = static_cast<int>(row % limbs);
    const size_t n = size_t{1} << log_n;
    const uint32_t qq = q[limb];
    const uint32_t qi = qinv[limb];
    uint32_t* outr = out + row * n;
    const uint32_t* twist = twist_m + limb * n;
    row_ntt_pass(y + row * n, roots_m + limb * n, qq, qi, log_n, [&](size_t i, uint32_t v) {
        outr[i] = INVERSE ? montmul(v, twist[i], qq, qi) : v;
    });
}

template <bool INVERSE>
int launch(const void* x, void* out, void* scratch, const void* q, const void* qinv, const void* twist_m,
           const void* roots_m, const void* tw_m, int rows, int limbs, int log_n, cudaStream_t stream) {
    const PassGrids g = pass_grids(rows, log_n);
    ntt_pass1<INVERSE><<<g.grid1, g.block1, 0, stream>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(scratch), static_cast<const uint32_t*>(q),
        static_cast<const uint32_t*>(qinv), static_cast<const uint32_t*>(twist_m),
        static_cast<const uint32_t*>(roots_m), static_cast<const uint32_t*>(tw_m), limbs, log_n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ntt_pass2<INVERSE><<<g.grid2, g.block2, 0, stream>>>(
        static_cast<const uint32_t*>(scratch), static_cast<uint32_t*>(out), static_cast<const uint32_t*>(q),
        static_cast<const uint32_t*>(qinv), static_cast<const uint32_t*>(twist_m),
        static_cast<const uint32_t*>(roots_m), limbs, log_n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out and scratch are (rows, n) and must not overlap; n = 2^log_n with
// 8 <= log_n <= 16.  Returns cudaGetLastError() after the launches.
extern "C" int ntt_launch(int inverse, const void* x, void* out, void* scratch, const void* q, const void* qinv,
                          const void* twist_m, const void* roots_m, const void* tw_m, int rows, int limbs, int n,
                          int log_n, void* stream) {
    if (!pass_size_ok(log_n) || n != (1 << log_n) || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    if (inverse) return launch<true>(x, out, scratch, q, qinv, twist_m, roots_m, tw_m, rows, limbs, log_n, s);
    return launch<false>(x, out, scratch, q, qinv, twist_m, roots_m, tw_m, rows, limbs, log_n, s);
}

// blocks[0], blocks[1]: the thread blocks ntt_launch starts for pass 1 and pass 2.
extern "C" int ntt_blocks(int rows, int log_n, int* blocks) {
    if (!pass_size_ok(log_n) || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    pass_block_counts(pass_grids(rows, log_n), blocks);
    return 0;
}
