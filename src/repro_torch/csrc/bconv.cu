// Fast basis conversion for the staged key-switch pipeline:
//   out[j, i] = Σ_s x̂[s, i]·W[s, j]  (mod c_j),  x̂ (k, n), W (k, m) → out (m, n).
//
// Replaces the Pallas kernel bconv_pallas (src/repro/kernels/bconv/kernel.py:56),
// with its arithmetic: x̂ and W cut into bytes, exact 8-bit products summed in
// int32 on the matrix unit, the byte diagonals recombined with the Montgomery
// constants C_m[j, d] = 2^(8d)·R mod c_j, and one reduction per output.  The
// products run on the int8 tensor cores (mma.sync m16n8k32, u8 × u8 → s32).
//
// GEMM view: for each byte a of x̂, A_a (n × k) u8 with A_a[i, s] = byte a of
// x̂[s, i]; B (k × 8) u8 over two targets j, j + 1 with B[s, 4·jl + b] = byte b
// of W[s, j + jl].  Then D_a[i, 4·jl + b] = P_ab = Σ_s byte_a(x̂)·byte_b(W) < k·255²,
// and with the 64-bit T = Σ_{a,b} P_ab·C_m[j, a + b] < 16·k·255²·c_j < c_j·2^32
// for k ≤ 64, one REDC (montredc64) gives the canonical Σ_s x̂[s, i]·W[s, j] mod
// c_j.  A k-step covers 32 source limbs; k pads to 32 or 64 with zero words.
//
// Fragments (PTX ISA, mma.m16n8k32 with .u8; lane (g, t) = (lane/4, lane%4)):
//   A register r of lane (g, t) holds A[g + 8(r & 1)][16(r >> 1) + 4t + e],
//   e = 0..3: byte a of the x̂ words at source limbs s0 + 16(r >> 1) + 4t + e of
//   one coefficient.  A lane loads those four words (8 lanes read 8 consecutive
//   coefficients, one 32-byte sector) and a 4 × 4 byte transpose of 8 byte
//   permutes (PRMT) gives its registers for all four planes a at once.  A warp
//   keeps them for every target of its block: 16 registers per k-step.
//   B register h of lane (g, t) holds B[16h + 4t + e][g]: bytes b = g & 3 of W
//   at source limbs s0 + 16h + 4t + e of target j + (g >> 2).  The host lays
//   these words out per target ((k-steps, t, b, h), as many words as W), so a
//   lane's two registers are one 8-byte shared-memory load.
//   C register i of lane (g, t) holds D[g + 8(i >> 1)][2t + (i & 1)]: target
//   j + (t >> 1), bytes b0 = 2(t & 1) and b0 + 1 of W.  A lane sums its 8 partial
//   sums of each row by diagonal d = a + b (5 of them, in 32 bits) and multiplies
//   each by C_m[j, d]; one shuffle with lane t ^ 1 (the other two bytes of W)
//   completes T, and each lane reduces and stores one output: row
//   g + 8(t & 1) of target j + (t >> 1).
//
// Tiling: a warp owns 16 consecutive coefficients, a block BCONV_WARPS warps.
// A block copies its chunk of targets' table rows (B words, C_m, c, −c^{-1})
// into shared memory while its A loads are in flight, and runs its warps over
// the chunk two targets at a time: four mma per k-step, one per byte plane.
// Target chunks split over blockIdx.y only where the coefficient blocks alone
// would not fill the card (N = 2^13).
//
// Byte planes in A, rather than the raw x̂ words with the 7 diagonals of one
// target in B's 8 columns, keep the tensor work at the 16 byte products a
// term needs: that layout spends 32 (one mma per target and 8 source limbs).
//
// Bound on the H100: bytes, at every preset shape.  The function reads k·n
// words and writes m·n; its k·m·n products are 16 int8 multiply-adds each on
// the tensor cores (1,979 TOP/s), and the integer work per output (5 wide
// multiply-adds a row, a shuffle, one REDC) does not grow with k.  A design
// with a montmul and an addmod per term needs 4.9 G integer instructions at
// 58 → 116 limbs and N = 2^16.  On the card the time follows the number of
// mma (4 per target pair and k-step) more than the bytes: mma.sync does not
// reach the tensor cores' peak rate.
#include <cuda_runtime.h>

#include <cstdint>

#include "montgomery.cuh"

namespace {

constexpr int BCONV_WARPS = 8;
constexpr int BCONV_THREADS = 32 * BCONV_WARPS;
constexpr int BCONV_COEFFS = 16 * BCONV_WARPS;  // coefficients of one block
constexpr int BCONV_KSTEP = 32;                 // source limbs of one mma
constexpr int BCONV_MAX_K = 64;                 // the TPU kernel's bound; P_ab < 2^22
constexpr int BCONV_SMEM_WORDS = 48 * 1024 / 4;
constexpr int BCONV_MIN_BLOCKS = 2 * 132;       // two blocks for each SM of an H100

// Targets per block (a block stages one table row of bconv_row words per
// target) and target chunks, for k source limbs, m targets and n coefficients.
struct BconvGrid {
    int tj, chunks;
};

// A target's table row: the B words of ks k-steps, then C_m (8), c, −c^{-1}
// and 6 zeros, so that rows stay 16-byte aligned.
constexpr int BCONV_ROW_TAIL = 16;
int bconv_row(int ks) { return BCONV_KSTEP * ks + BCONV_ROW_TAIL; }

BconvGrid bconv_grid(int k, int m, int n) {
    const int xblocks = n / BCONV_COEFFS;
    int chunks = (BCONV_MIN_BLOCKS + xblocks - 1) / xblocks;
    chunks = chunks < 1 ? 1 : (chunks > m ? m : chunks);
    int tj = (m + chunks - 1) / chunks;
    const int tj_max = BCONV_SMEM_WORDS / bconv_row((k + BCONV_KSTEP - 1) / BCONV_KSTEP);
    if (tj > tj_max) tj = tj_max;
    return {tj, (m + tj - 1) / tj};
}

bool bconv_shape_ok(int k, int m, int n) {
    return k >= 1 && k <= BCONV_MAX_K && m >= 1 && n >= BCONV_COEFFS && n % BCONV_COEFFS == 0;
}

__device__ __forceinline__ void mma_u8(int* acc, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

//   x:   (k, n)  prescaled source limbs x̂
//   tab: (m, bconv_row(KS))  per target j: the B words (KS, 4, 4, 2), where
//        [ks, t, b, h] has byte e = byte b of W[32ks + 16h + 4t + e, j] (0 past
//        row k); C_m[j, 0..7] = 2^(8d)·R mod c_j (C_m[j, 7] = 0); c_j; −c_j^{-1}
//        mod 2^32; zeros
//   out: (m, n)
// Block (blockIdx.x, blockIdx.y): coefficients [BCONV_COEFFS·x, +BCONV_COEFFS),
// targets [tj·y, tj·y + tj) ∩ [0, m).  KS = ceil(k / 32).
// Four blocks an SM, so at most 64 registers: at KS = 2 ptxas spills 12 bytes
// for it, at no cost in time, and at KS = 1 the bound lets it unroll further.
template <int KS>
__global__ void __launch_bounds__(BCONV_THREADS, 4)
    bconv_kernel(const uint32_t* __restrict__ x, int k, const uint32_t* __restrict__ tab, int m,
                 uint32_t* __restrict__ out, int n, int tj) {
    constexpr int KPAD = BCONV_KSTEP * KS;
    constexpr int ROW = KPAD + BCONV_ROW_TAIL;
    extern __shared__ __align__(16) uint32_t s_tab[];  // (tj, ROW): the chunk's table rows
    const int j0 = blockIdx.y * tj;
    const int nt = min(tj, m - j0);

    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t i0 = static_cast<size_t>(blockIdx.x) * BCONV_COEFFS + (threadIdx.x >> 5) * 16;
    uint32_t a[KS][4][4];  // [k-step][byte plane][register]
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            uint32_t v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int s = BCONV_KSTEP * ks + 16 * (r >> 1) + 4 * t + e;
                v[e] = s < k ? x[static_cast<size_t>(s) * n + i0 + g + 8 * (r & 1)] : 0u;
            }
            // 4 × 4 byte transpose: plane a takes byte a of v[0..3]
            const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140), lo23 = __byte_perm(v[2], v[3], 0x5140);
            const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362), hi23 = __byte_perm(v[2], v[3], 0x7362);
            a[ks][0][r] = __byte_perm(lo01, lo23, 0x5410);
            a[ks][1][r] = __byte_perm(lo01, lo23, 0x7632);
            a[ks][2][r] = __byte_perm(hi01, hi23, 0x5410);
            a[ks][3][r] = __byte_perm(hi01, hi23, 0x7632);
        }
    }
    const uint4* src = reinterpret_cast<const uint4*>(tab + static_cast<size_t>(j0) * ROW);
    for (int idx = threadIdx.x; idx < nt * ROW / 4; idx += BCONV_THREADS)
        reinterpret_cast<uint4*>(s_tab)[idx] = src[idx];
    __syncthreads();

    const int boff = 8 * t + 2 * (g & 3);  // this lane's B words (h = 0, 1) in a target's k-step
    const int b0 = 2 * (t & 1);            // this lane's C columns: bytes b0, b0 + 1 of W
    // targets two at a time; a pair past nt repeats target nt − 1 and stores nothing for it
    for (int jb = 0; jb < nt; jb += 2) {
        const int jw = min(jb + (g >> 2), nt - 1);
        int acc[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            const uint2 bv = *reinterpret_cast<const uint2*>(s_tab + jw * ROW + BCONV_KSTEP * ks + boff);
#pragma unroll
            for (int p = 0; p < 4; ++p) mma_u8(acc[p], a[ks][p], bv.x, bv.y);
        }
        const int jj = min(jb + (t >> 1), nt - 1);
        const uint32_t* row = s_tab + jj * ROW + KPAD;  // C_m[jj], c, −c^{-1}
        // diagonal e of this lane's columns: Σ over planes a and bytes b0 + q with a + q = e
        const uint32_t row_g[5] = {static_cast<uint32_t>(acc[0][0]), static_cast<uint32_t>(acc[1][0] + acc[0][1]),
                                   static_cast<uint32_t>(acc[2][0] + acc[1][1]),
                                   static_cast<uint32_t>(acc[3][0] + acc[2][1]), static_cast<uint32_t>(acc[3][1])};
        const uint32_t row_g8[5] = {static_cast<uint32_t>(acc[0][2]), static_cast<uint32_t>(acc[1][2] + acc[0][3]),
                                    static_cast<uint32_t>(acc[2][2] + acc[1][3]),
                                    static_cast<uint32_t>(acc[3][2] + acc[2][3]), static_cast<uint32_t>(acc[3][3])};
        uint64_t lo = 0, hi = 0;
#pragma unroll
        for (int e = 0; e < 5; ++e) {
            const uint32_t cd = row[b0 + e];
            lo += static_cast<uint64_t>(row_g[e]) * cd;
            hi += static_cast<uint64_t>(row_g8[e]) * cd;
        }
        // even t keeps row g, odd t row g + 8, each adding the other lane's bytes
        uint64_t v = (t & 1) ? hi : lo;
        v += __shfl_xor_sync(0xffffffffu, (t & 1) ? lo : hi, 1);
        if (jb + (t >> 1) < nt)
            out[static_cast<size_t>(j0 + jj) * n + i0 + g + 8 * (t & 1)] = montredc64(v, row[8], row[9]);
    }
}

template <int KS>
int launch(const void* x, int k, const void* tab, int m, void* out, int n, cudaStream_t stream) {
    const BconvGrid gr = bconv_grid(k, m, n);
    const size_t smem = static_cast<size_t>(gr.tj) * bconv_row(KS) * sizeof(uint32_t);
    bconv_kernel<KS><<<dim3(n / BCONV_COEFFS, gr.chunks), BCONV_THREADS, smem, stream>>>(
        static_cast<const uint32_t*>(x), k, static_cast<const uint32_t*>(tab), m, static_cast<uint32_t*>(out), n,
        gr.tj);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 <= k <= 64, m >= 1, n a multiple of 128; tab as bconv_kernel takes it.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int bconv_launch(const void* x, int k, const void* tab, int m, void* out, int n, void* stream) {
    if (!bconv_shape_ok(k, m, n)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return k <= BCONV_KSTEP ? launch<1>(x, k, tab, m, out, n, s) : launch<2>(x, k, tab, m, out, n, s);
}

// The grid bconv_launch starts: blocks[0] coefficient blocks (BCONV_COEFFS
// each) by blocks[1] target chunks.
extern "C" int bconv_blocks(int k, int m, int n, int* blocks) {
    if (!bconv_shape_ok(k, m, n)) return static_cast<int>(cudaErrorInvalidValue);
    blocks[0] = n / BCONV_COEFFS;
    blocks[1] = bconv_grid(k, m, n).chunks;
    return 0;
}
