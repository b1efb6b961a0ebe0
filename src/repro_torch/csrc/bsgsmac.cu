// The diagonal products and sums of a BSGS matvec, every giant group at once.
//
// Replaces no TPU kernel: the reference runs a matvec's inner sums as one
// mulmod per diagonal and component and one addmod per term after a giant
// group's first (src/repro/fhe/linear.py, _apply_bsgs), each a modops
// launch (mulmod_pallas, addmod_pallas).  This kernel computes the same sums
// in one launch:
//
//   out[g, c, l, i] = Σ_{d in giant g} diag[d, l, i] · baby[bidx[d], c, l, i]  mod q_l
//
// each product by one montmul (a·b·R⁻¹), the group's products summed exactly
// in 64 bits (a sum of fewer than 2^32 terms below q stays below q·2^32),
// then one REDC of the sum and one montmul by R³ give Σ a·b mod q: the same
// residue as the reference's chain, since modular sums are exact.
//
// Bound on the H100: bytes.  Each diagonal word is read once and feeds two
// montmuls (c0 and c1) with one 16-byte load per four residues, about 20
// integer operations against 12 bytes of traffic, far below the card's
// ratio.  The design: four residues a thread (16-byte loads and stores);
// a thread computes both components of its output, so each diagonal word
// is loaded once; the diagonals (470 MB of an lstm plan, past the 50 MB L2)
// stream through with an evict-first load (ld.global.cs); the grid puts the
// giant index on x, so the G blocks of one (limb, N-tile) run back to back
// and all but the first read the babies' tile from L2.  The output is one
// partial sum per giant, (G, 2, l, N), which the giant rotations read next.
#include <cuda_runtime.h>

#include <cstdint>

#include "montgomery.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;

__device__ __forceinline__ void mac4(uint64_t* acc, const uint4& x, const uint4& y, uint32_t q, uint32_t qinv) {
    acc[0] += montmul(x.x, y.x, q, qinv);
    acc[1] += montmul(x.y, y.y, q, qinv);
    acc[2] += montmul(x.z, y.z, q, qinv);
    acc[3] += montmul(x.w, y.w, q, qinv);
}

// Σ montmul(a, b) = Σ a·b·R⁻¹ (as an integer) → Σ a·b mod q, canonical.
__device__ __forceinline__ uint4 finish4(const uint64_t* acc, uint32_t q, uint32_t qinv, uint32_t r3) {
    uint4 o;
    o.x = montmul(montredc64(acc[0], q, qinv), r3, q, qinv);
    o.y = montmul(montredc64(acc[1], q, qinv), r3, q, qinv);
    o.z = montmul(montredc64(acc[2], q, qinv), r3, q, qinv);
    o.w = montmul(montredc64(acc[3], q, qinv), r3, q, qinv);
    return o;
}

// Block (giant g, N-tile, limb); one thread per four residues of the tile.
//   diags:    (D, limbs, n) rows grouped by giant: group g is rows offsets[g] .. offsets[g+1]-1
//   babies:   (B, 2, limbs, n) the baby rotations' c0 and c1
//   baby_idx: (D,) the row of babies each diagonal multiplies
//   q/qinv/r2: (limbs,) moduli and their Montgomery constants
//   out:      (G, 2, limbs, n)
__global__ void __launch_bounds__(THREADS)
    bsgs_mac_kernel(const uint4* __restrict__ diags, const uint4* __restrict__ babies,
                    const int* __restrict__ baby_idx, const int* __restrict__ offsets,
                    const uint32_t* __restrict__ q, const uint32_t* __restrict__ qinv,
                    const uint32_t* __restrict__ r2, uint4* __restrict__ out, int limbs, int n_vec) {
    const int g = blockIdx.x;
    const int limb = blockIdx.z;
    const int v = blockIdx.y * THREADS + threadIdx.x;
    if (v >= n_vec) return;
    const uint32_t qq = q[limb];
    const uint32_t qi = qinv[limb];
    const uint32_t r3 = montmul(r2[limb], r2[limb], qq, qi);  // R²·R²·R⁻¹ = R³ mod q
    const size_t poly = static_cast<size_t>(limbs) * n_vec;  // one (limbs, n) polynomial, in uint4
    const size_t at = static_cast<size_t>(limb) * n_vec + v;
    uint64_t acc0[VEC] = {0, 0, 0, 0};
    uint64_t acc1[VEC] = {0, 0, 0, 0};
    const int end = offsets[g + 1];
#pragma unroll 4
    for (int d = offsets[g]; d < end; ++d) {
        const uint4 x = __ldcs(diags + static_cast<size_t>(d) * poly + at);
        const uint4* b = babies + static_cast<size_t>(baby_idx[d]) * 2 * poly + at;
        const uint4 y0 = __ldg(b);
        const uint4 y1 = __ldg(b + poly);
        mac4(acc0, x, y0, qq, qi);
        mac4(acc1, x, y1, qq, qi);
    }
    uint4* o = out + static_cast<size_t>(g) * 2 * poly + at;
    o[0] = finish4(acc0, qq, qi, r3);
    o[poly] = finish4(acc1, qq, qi, r3);
}

}  // namespace

// diags: (D, limbs, n); babies: (B, 2, limbs, n); baby_idx: (D,) int32 rows of
// babies; offsets: (giants + 1,) int32, nondecreasing, offsets[giants] = D;
// q, qinv, r2: (limbs,); out: (giants, 2, limbs, n).  n a multiple of 4 and
// every base 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int bsgs_mac_launch(const void* diags, const void* babies, const void* baby_idx, const void* offsets,
                               int giants, int limbs, int n, const void* q, const void* qinv, const void* r2,
                               void* out, void* stream) {
    if (giants < 1 || limbs < 1 || limbs > 65535 || n < VEC || n % VEC) return static_cast<int>(cudaErrorInvalidValue);
    const int n_vec = n / VEC;
    const dim3 grid(giants, (n_vec + THREADS - 1) / THREADS, limbs);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    bsgs_mac_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(diags), static_cast<const uint4*>(babies), static_cast<const int*>(baby_idx),
        static_cast<const int*>(offsets), static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qinv),
        static_cast<const uint32_t*>(r2), static_cast<uint4*>(out), limbs, n_vec);
    return static_cast<int>(cudaGetLastError());
}
