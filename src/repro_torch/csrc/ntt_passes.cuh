// Two-pass (four-step) negacyclic NTT: the device code shared by ntt.cu,
// fusedks.cu and hoistrot.cu, which spreads every limb over many thread blocks.
//
// Split N = N1·N2 with N1 = 2^floor(log2(N)/2) (2^16 = 2^8·2^8, 2^13 = 2^6·2^7)
// and write n = N2·n1 + n2, k = k1 + N1·k2.  The cyclic NTT over w is then
//   pass 1: for every column n2, the N1-point NTT over n1 with root w^N2,
//           times the inter-pass twiddle w^(n2·k1), stored as Y[k1·N2 + n2];
//   pass 2: for every row k1 of Y, the N2-point NTT over n2 with root w^N1,
//           stored as X[k1 + N1·k2], which is natural order.
// The negacyclic twist rides on the ends: x[i]·psi^i on pass 1's load
// (forward), ·psi^-i·N^-1 on pass 2's store (inverse).
//
// A pass-1 block owns PASS_TILE consecutive columns (64-byte row segments,
// N1·PASS_TILE words in shared memory); a pass-2 block owns PASS_TILE
// consecutive rows, staged through shared memory so that its stride-N1
// stores of X still go out as 64-byte segments.  Each sub-NTT is radix-2
// decimation in frequency (natural order in, bit-reversed out), so no
// permutation pass is needed: the first group of stages reads its inputs
// where the caller's load says and the last group hands each output, with its
// bit-reversed position, to the caller's store.  Each thread holds
// PASS_SLOTS = 8 coefficients in registers and runs up to three stages on them
// between shared-memory exchanges: an 8-stage sub-NTT takes 2 barriers.
//
// Tensor cores are not used.  The TPU ran its sub-NTTs as 8-bit-limb int32
// matmuls on the MXU; on Hopper the 16 int8 partial products of one 32-bit
// product cost more than the integer pipes spend on the butterflies.
// Every value stays canonical in [0, q) (montmul, addmod, submod of
// montgomery.cuh), so the output is bit-identical to any exact NTT.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "montgomery.cuh"

constexpr int PASS_TILE = 16;     // columns of a pass-1 block, rows of a pass-2 block
constexpr int PASS_SLOTS = 8;     // coefficients a thread holds per group of stages
constexpr int PASS_MAX_LOG_M = 8;  // sub-NTTs of up to 256 points: N <= 2^16
constexpr int PASS_MIN_LOG_N = 8;  // N1 >= PASS_TILE
constexpr int PASS_MAX_THREADS = PASS_TILE * (1 << PASS_MAX_LOG_M) / PASS_SLOTS;
// A tile: PASS_TILE columns of up to 256 words, padded by one word per row in pass 2.
constexpr int PASS_TILE_WORDS = PASS_TILE * ((1 << PASS_MAX_LOG_M) + 1);

__host__ __device__ constexpr int pass_log_n1(int log_n) { return log_n / 2; }

// The low `bits` bits of i, reversed (bits >= 1).
__device__ __forceinline__ int rev_bits(int i, int bits) {
    return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - bits));
}

// sub[e] = roots[e << log_stride] for e < M/2 = 2^(log_m - 1): the powers of the
// M-point root w^(N/M), from the limb's table of w^i·R.
__device__ __forceinline__ void load_sub_roots(uint32_t* sub, const uint32_t* __restrict__ roots, int log_m,
                                               int log_stride) {
    for (int e = threadIdx.x; e < (1 << (log_m - 1)); e += blockDim.x) sub[e] = roots[static_cast<size_t>(e) << log_stride];
}

// One group of G <= 3 DIF stages, s0 + G - 1 down to s0, of an M-point
// sub-NTT (M = 2^log_m) on each of the tile's PASS_TILE columns.  Element
// (pos, col) lives at sm[pos·ps + col·cs].  Thread t works on column
// t % PASS_TILE and on PASS_SLOTS / 2^G tasks of 2^G coefficients each, at
// positions base + b·2^s0; the stage with half-size h = 2^s pairs positions
// i and i + h and multiplies the difference by w_M^(j·M/2h), j = i mod h.
// The first group takes its inputs from load(pos, col, v), which fills
// v[slot] with element (pos[slot], col) for every slot < PASS_SLOTS at once (so
// a load from device memory can keep all of them in flight); the last gives
// its outputs to store(pos, col, slot, value).  A slot names the same
// (pos, col) of the same thread in every call with the same log_m.
template <int G, class Load, class Store>
__device__ __forceinline__ void dif_group(uint32_t* sm, int ps, int cs, int log_m, int s0, bool first, bool last,
                                          const uint32_t* sub, uint32_t q, uint32_t qinv, Load& load, Store& store) {
    constexpr int B = 1 << G;
    constexpr int U = PASS_SLOTS / B;
    const int col = threadIdx.x % PASS_TILE;
    const int groups_per_round = blockDim.x / PASS_TILE;
    uint32_t v[PASS_SLOTS];
    int pos[PASS_SLOTS];
    int low[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int grp = threadIdx.x / PASS_TILE + u * groups_per_round;
        low[u] = grp & ((1 << s0) - 1);
        const int base = ((grp >> s0) << (s0 + G)) | low[u];
#pragma unroll
        for (int b = 0; b < B; ++b) pos[u * B + b] = base + (b << s0);
    }
    if (first) {
        load(pos, col, v);
    } else {
#pragma unroll
        for (int x = 0; x < PASS_SLOTS; ++x) v[x] = sm[pos[x] * ps + col * cs];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = G - 1; g >= 0; --g) {
            const int shift = log_m - 1 - (s0 + g);
#pragma unroll
            for (int b = 0; b < B; ++b) {
                if (b & (1 << g)) continue;
                const int j = low[u] + ((b & ((1 << g) - 1)) << s0);
                const uint32_t a0 = v[u * B + b];
                const uint32_t a1 = v[u * B + b + (1 << g)];
                v[u * B + b] = addmod(a0, a1, q);
                v[u * B + b + (1 << g)] = montmul(submod(a0, a1, q), sub[j << shift], q, qinv);
            }
        }
    }
#pragma unroll
    for (int x = 0; x < PASS_SLOTS; ++x) {
        if (last) {
            store(pos[x], col, x, v[x]);
        } else {
            sm[pos[x] * ps + col * cs] = v[x];
        }
    }
}

// The M-point cyclic DIF NTT (natural order in, bit-reversed out) of every
// column of the tile, 16 <= M <= 256, run by PASS_TILE·M/8 threads: groups of
// three stages from the top, a barrier between groups.  `sub` holds the M/2
// root powers (load_sub_roots) and must be visible to the block; a caller whose
// load reads shared memory puts the barrier after filling it.
template <class Load, class Store>
__device__ __forceinline__ void dif_columns(uint32_t* sm, int ps, int cs, int log_m, const uint32_t* sub,
                                            uint32_t q, uint32_t qinv, Load load, Store store) {
    for (int top = log_m - 1; top >= 0; top -= 3) {
        const int g = top >= 2 ? 3 : top + 1;
        const int s0 = top - g + 1;
        const bool first = top == log_m - 1;
        const bool last = s0 == 0;
        if (!first) __syncthreads();
        if (g == 3) {
            dif_group<3>(sm, ps, cs, log_m, s0, first, last, sub, q, qinv, load, store);
        } else if (g == 2) {
            dif_group<2>(sm, ps, cs, log_m, s0, first, last, sub, q, qinv, load, store);
        } else {
            dif_group<1>(sm, ps, cs, log_m, s0, first, last, sub, q, qinv, load, store);
        }
    }
}

// Pass 2's staging: rows r0..r0+PASS_TILE of y (N2 = 2^log_n2 words each) into
// tile[r·(N2+1) + p], read as contiguous rows.  No barrier.  The padding word
// keeps the column-major reads of staged_load off a single bank.
__device__ __forceinline__ void stage_rows(uint32_t* tile, const uint32_t* __restrict__ y, int r0, int log_n2) {
    const int n2 = 1 << log_n2;
    for (int idx = threadIdx.x; idx < PASS_TILE << log_n2; idx += blockDim.x) {
        const int r = idx >> log_n2;
        const int p = idx & (n2 - 1);
        tile[r * (n2 + 1) + p] = y[(static_cast<size_t>(r0 + r) << log_n2) + p];
    }
}

// The first group's load of a tile that stage_rows filled: element (pos, col)
// at tile[col·(N2+1) + pos].
__device__ __forceinline__ auto staged_load(const uint32_t* tile, int log_n2) {
    const int ld = (1 << log_n2) + 1;
    return [=](const int* pos, int col, uint32_t* v) {
#pragma unroll
        for (int x = 0; x < PASS_SLOTS; ++x) v[x] = tile[col * ld + pos[x]];
    };
}

// Pass 2 of a forward NTT, run by the whole block: rows r0..r0+PASS_TILE of one
// limb's intermediate y (r0 = blockIdx.x·PASS_TILE), staged, the N2-point row
// NTTs over roots (the limb's w^i·R), and each output handed to store(i, v)
// with its natural-order index i = k1 + N1·k2.  Consecutive threads get
// consecutive k1, so a store to a row of N words goes out as 64-byte segments.
// The NTT's pass 2 and the pass B of fused_moddown and hoist_modup run it.
template <class Store>
__device__ __forceinline__ void row_ntt_pass(const uint32_t* __restrict__ y, const uint32_t* __restrict__ roots,
                                             uint32_t q, uint32_t qinv, int log_n, Store store) {
    __shared__ uint32_t tile[PASS_TILE_WORDS];
    __shared__ uint32_t sub[1 << (PASS_MAX_LOG_M - 1)];
    const int log_n1 = pass_log_n1(log_n);
    const int log_n2 = log_n - log_n1;
    const int r0 = blockIdx.x * PASS_TILE;
    load_sub_roots(sub, roots, log_n2, log_n1);
    stage_rows(tile, y, r0, log_n2);
    __syncthreads();
    dif_columns(tile, 1, (1 << log_n2) + 1, log_n2, sub, q, qinv, staged_load(tile, log_n2),
                [&](int pos, int col, int, uint32_t v) {
                    store(r0 + col + (static_cast<size_t>(rev_bits(pos, log_n2)) << log_n1), v);
                });
}

// Host side: the two launches over `rows` limbs of N = 2^log_n.  Pass 1 has
// N2/PASS_TILE column tiles per row, pass 2 N1/PASS_TILE row tiles.
struct PassGrids {
    dim3 grid1, block1, grid2, block2;
};

inline bool pass_size_ok(int log_n) { return log_n >= PASS_MIN_LOG_N && log_n <= 2 * PASS_MAX_LOG_M; }

inline PassGrids pass_grids(int rows, int log_n) {
    const int log_n1 = pass_log_n1(log_n);
    const int log_n2 = log_n - log_n1;
    return PassGrids{dim3((1u << log_n2) / PASS_TILE, rows), dim3((PASS_TILE << log_n1) / PASS_SLOTS),
                     dim3((1u << log_n1) / PASS_TILE, rows), dim3((PASS_TILE << log_n2) / PASS_SLOTS)};
}

// blocks[0], blocks[1]: thread blocks of pass 1 and pass 2.
inline void pass_block_counts(const PassGrids& g, int* blocks) {
    blocks[0] = static_cast<int>(g.grid1.x * g.grid1.y);
    blocks[1] = static_cast<int>(g.grid2.x * g.grid2.y);
}
