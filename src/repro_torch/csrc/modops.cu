// Limb-wise modular multiply / add / subtract over (rows, N) residues.
//
// Replaces the Pallas kernels mulmod_pallas, addmod_pallas and submod_pallas
// (src/repro/kernels/modops/kernel.py:62, 76, 90): one kernel with an op switch.
// Row r uses modulus q[r % limbs], so a (batch, limbs, N) tensor is passed
// flattened and the per-limb constants are not tiled.
//
// Bound on the H100: bytes.  Each element reads 8 bytes and writes 4 and costs
// at most two Montgomery multiplies, far below the integer issue rate, so
// the kernel can only approach 3.35 TB/s.  The design does what that needs:
// 16-byte loads and stores (four residues per thread), consecutive threads on
// consecutive addresses, and the row's constants read once per thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "montgomery.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;

enum Op { MUL = 0, ADD = 1, SUB = 2 };

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b, uint32_t q, uint32_t qinv, uint32_t r2) {
    if (OP == MUL) return mulmod(a, b, q, qinv, r2);
    if (OP == ADD) return addmod(a, b, q);
    return submod(a, b, q);
}

template <int OP>
__global__ void __launch_bounds__(THREADS) modops_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                                                         uint4* __restrict__ out, const uint32_t* __restrict__ q,
                                                         const uint32_t* __restrict__ qinv,
                                                         const uint32_t* __restrict__ r2, int limbs, int n_vec) {
    const int row = blockIdx.y;
    const int v = blockIdx.x * THREADS + threadIdx.x;
    if (v >= n_vec) return;
    const int limb = row % limbs;
    const uint32_t qq = q[limb];
    const uint32_t qi = OP == MUL ? qinv[limb] : 0u;
    const uint32_t rr = OP == MUL ? r2[limb] : 0u;
    const size_t at = static_cast<size_t>(row) * n_vec + v;
    const uint4 x = a[at];
    const uint4 y = b[at];
    uint4 o;
    o.x = apply<OP>(x.x, y.x, qq, qi, rr);
    o.y = apply<OP>(x.y, y.y, qq, qi, rr);
    o.z = apply<OP>(x.z, y.z, qq, qi, rr);
    o.w = apply<OP>(x.w, y.w, qq, qi, rr);
    out[at] = o;
}

}  // namespace

// op: 0 mul, 1 add, 2 sub.  a, b, out: (rows, n) residues, n a multiple of 4,
// 16-byte aligned; q, qinv, r2: (limbs,) per-limb constants (qinv and r2 are
// read only for mul).  Returns cudaGetLastError() after the launch.
extern "C" int modops_launch(int op, const void* a, const void* b, void* out, const void* q, const void* qinv,
                             const void* r2, int rows, int limbs, int n, void* stream) {
    const int n_vec = n / VEC;
    const dim3 grid((n_vec + THREADS - 1) / THREADS, rows);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* av = static_cast<const uint4*>(a);
    const auto* bv = static_cast<const uint4*>(b);
    auto* ov = static_cast<uint4*>(out);
    const auto* qp = static_cast<const uint32_t*>(q);
    const auto* ip = static_cast<const uint32_t*>(qinv);
    const auto* rp = static_cast<const uint32_t*>(r2);
    if (op == MUL) {
        modops_kernel<MUL><<<grid, THREADS, 0, s>>>(av, bv, ov, qp, ip, rp, limbs, n_vec);
    } else if (op == ADD) {
        modops_kernel<ADD><<<grid, THREADS, 0, s>>>(av, bv, ov, qp, ip, rp, limbs, n_vec);
    } else if (op == SUB) {
        modops_kernel<SUB><<<grid, THREADS, 0, s>>>(av, bv, ov, qp, ip, rp, limbs, n_vec);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
