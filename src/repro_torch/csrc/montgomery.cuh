// Modular arithmetic on uint32_t residues for primes q < 2^31, shared by every
// kernel of repro_torch.  Montgomery form uses R = 2^32; the high word of each
// 32x32-bit product comes from __umulhi (the TPU kernels built it from 16-bit
// limbs: _mulhi32/_montmul in src/repro/kernels/ntt/kernel.py:29-46).
//
// Residues live in int32 tensors on the PyTorch side; every value is < 2^31,
// so the bit pattern read here as uint32_t is the same number.
#pragma once

#include <cstdint>

// a·b·R^{-1} mod q, canonical in [0, q).  Needs a·b < q·2^32, which holds
// whenever one factor is < q and the other < 2^32.
__device__ __forceinline__ uint32_t montmul(uint32_t a, uint32_t b, uint32_t q, uint32_t qinv_neg) {
    const uint32_t t_lo = a * b;
    const uint32_t t_hi = __umulhi(a, b);
    const uint32_t m = t_lo * qinv_neg;  // t + m·q ≡ 0 (mod 2^32)
    const uint32_t mq_hi = __umulhi(m, q);
    // the low words cancel; they carry 1 into the high word unless t_lo == 0
    const uint32_t res = t_hi + mq_hi + (t_lo != 0u);  // < 2q < 2^32
    return res >= q ? res - q : res;
}

// t·R^{-1} mod q for a 64-bit t < q·2^32, canonical in [0, q): the REDC that
// montmul ends with, for a sum of products formed elsewhere.
__device__ __forceinline__ uint32_t montredc64(uint64_t t, uint32_t q, uint32_t qinv_neg) {
    const uint32_t t_lo = static_cast<uint32_t>(t);
    const uint32_t m = t_lo * qinv_neg;
    const uint32_t res = static_cast<uint32_t>(t >> 32) + __umulhi(m, q) + (t_lo != 0u);  // < 2q
    return res >= q ? res - q : res;
}

// (a·b) mod q for plain (non-Montgomery) a, b < q: a·b·R^{-1}, then ·R^2·R^{-1}.
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, uint32_t q, uint32_t qinv_neg,
                                           uint32_t r2) {
    return montmul(montmul(a, b, q, qinv_neg), r2, q, qinv_neg);
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b, uint32_t q) {
    const uint32_t s = a + b;  // < 2q < 2^32
    return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b, uint32_t q) {
    return a >= b ? a - b : a + q - b;
}
