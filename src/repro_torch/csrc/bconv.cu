// Fast basis conversion for the staged key-switch pipeline:
//   out[j, i] = Σ_s x̂[s, i]·W[s, j]  (mod c_j),  x̂ (k, n), W (k, m) → out (m, n).
//
// Replaces the Pallas kernel bconv_pallas (src/repro/kernels/bconv/kernel.py:56).
// The TPU kernel padded k and m to multiples of 8 (a dummy modulus 3 on the
// padded rows) and ran the sum as 8-bit-limb int32 dots on the MXU; none of
// that carries over.  Here each thread owns one (target limb j, coefficient i)
// and runs the shared bconv_coeff of bconv_core.cuh (the routine fused_ks and
// hoist_modup run too): every term is one montmul against W[s, j]·R, reduced
// before it is added.  Neighbouring threads read neighbouring coefficients.
//
// Bound on the H100: bytes.  The function reads k·n words and writes m·n;
// its k·m·n montmuls are ~11 integer operations each, which at the main
// path's shapes (k ≤ 7, m ≤ 21) take about as long as the bytes at the
// card's integer rate.  The grid is (n/256, m) blocks: 256·21 at lstm, enough
// to fill the 132 SMs.  Each source row is read once per target limb, through
// L2 (the whole input is at most 2 MB on the main path).
#include <cuda_runtime.h>

#include <cstdint>

#include "bconv_core.cuh"

namespace {

constexpr int BCONV_THREADS = 256;

//   x:     (k, n)  prescaled source limbs
//   w_m:   (k, m)  W[s, j]·R mod c_j
//   c, cinv: (m,)  target moduli and their −c^{-1} mod 2^32
//   out:   (m, n)
__global__ void __launch_bounds__(BCONV_THREADS)
    bconv_kernel(const uint32_t* __restrict__ x, int k, const uint32_t* __restrict__ w_m, int m,
                 const uint32_t* __restrict__ c, const uint32_t* __restrict__ cinv, uint32_t* __restrict__ out, int n) {
    const int j = blockIdx.y;
    const size_t i = static_cast<size_t>(blockIdx.x) * BCONV_THREADS + threadIdx.x;
    if (i >= static_cast<size_t>(n)) return;
    out[static_cast<size_t>(j) * n + i] =
        bconv_coeff<false>(x, i, n, 0, k, nullptr, nullptr, nullptr, w_m, m, j, c[j], cinv[j]);
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int bconv_launch(const void* x, int k, const void* w_m, int m, const void* c, const void* cinv, void* out,
                            int n, void* stream) {
    const dim3 grid((n + BCONV_THREADS - 1) / BCONV_THREADS, m);
    bconv_kernel<<<grid, BCONV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), k, static_cast<const uint32_t*>(w_m), m, static_cast<const uint32_t*>(c),
        static_cast<const uint32_t*>(cinv), static_cast<uint32_t*>(out), n);
    return static_cast<int>(cudaGetLastError());
}
