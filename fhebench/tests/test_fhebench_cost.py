"""The frozen work count: the smoke script's per-kernel bounds (PERF.md's kernel
table) from shapes alone, a whole ``ctx.mul`` counted by hand, and a key-switch
that counts the same work however its pieces are launched."""

import pytest

from fhebench import cost
from fhebench.cost import eval_mod, lola

N16 = 1 << 16


@pytest.mark.parametrize("k, m, limbs, want_ms", [(58, 116, None, 0.0136), (None, None, 14, 0.0044)])
def test_pieces_give_the_kernel_tables_bytes_bounds(k, m, limbs, want_ms):
    """PERF.md's kernel table bounds bconv at 58 → 116 (0.0136 ms) and the NTT of 14
    limbs at lstm (0.0044 ms) by their bytes: the count's own pieces are faster by
    their operations, and their bytes at the count's rates give the table's times."""
    work, nbytes = ((cost.bconv(N16, k, m), (k + m) * N16 * cost.WORD) if k else
                    (cost.ntt(N16, limbs), 4 * limbs * N16 * cost.WORD))
    assert round(nbytes / cost.PEAK_BYTES_PER_S * 1e3, 4) == want_ms
    assert work.seconds * 1e3 < want_ms


@pytest.mark.parametrize("level, alpha, table_ms", [(13, 7, 0.0195 + 0.0116), (57, 58, 0.1815 + 0.1763)])
def test_whole_key_switch_stays_under_the_kernel_tables_bounds(level, alpha, table_ms):
    """The table's fused_ks and fused_moddown bounds (lstm at level 13; packed_bootstrap
    at 58 → 116) count the NTT's products on the ALU; the whole key-switch counts them on
    the tensor cores, so its least time lies under their sum, and above its own bytes."""
    w = cost.key_switch(N16, level, alpha)
    assert w.nbytes / cost.PEAK_BYTES_PER_S < w.seconds < table_ms * 1e-3


def test_whole_mul_counted_by_hand():
    """ctx.mul at n = 2^9, L = 6, dnum = 2 (α = 4), level 6: 7 limbs, digits of 4 and 3, 11 extended limbs."""
    n = 512
    w = cost.op("mul", n, 6, 4)
    assert w.nbytes == 2 * 2 * 7 * n * 4 + 2 * 2 * 11 * n * 4 + 2 * 6 * n * 4  # two inputs, the key, the output
    ntt_rows = (7 + 7 + 8) + 2 * (4 + 7) + 2 * (1 + 6)  # ModUp; two ModDowns; the rescale's two polynomials
    ntt_alu = ntt_rows * ((256 * 9 + 512) * 6 + 256 * 9 * 2 * 3)
    alu = (7 * n * (4 * 16 + 3)  # tensor product: 4 products, 1 add
           + (4 * n * 16 + 7 * n * 8) + (3 * n * 16 + 8 * n * 8)  # ModUp BConvs 4 → 7 and 3 → 8
           + 22 * n * (2 * 16 + 3)  # MAC over 2 × 11 rows
           + 2 * ((4 * n * 16 + 7 * n * 8) + 7 * n * 19)  # two ModDowns: BConv 4 → 7, subtract and × P^-1
           + 14 * n * 3  # adding the key-switch
           + 2 * (6 * n * 3 + 6 * n * 19)  # rescale: re-embed, subtract and × q^-1
           + ntt_alu)
    int8 = 32 * (4 * 7 * n + 3 * 8 * n + 2 * 4 * 7 * n + ntt_rows * (256 * 9 + 512))
    assert (w.alu, w.int8) == (alu, int8)
    assert w.seconds == pytest.approx(max(w.nbytes / 3.35e12, alu / 33.5e12 + int8 / 1979e12))


@pytest.mark.parametrize("n, level, alpha", [(512, 6, 4), (N16, 13, 7), (N16, 57, 58), (N16, 9, 7)])
def test_fused_and_staged_key_switch_count_the_same(n, level, alpha):
    """The staged pipeline launches INTT, per digit BConv and NTT, the MAC, then per
    accumulator INTT, BConv, NTT and the tail; the fused one launches fused_ks (ModUp
    and MAC) and fused_moddown (both tails).  Summed piece by piece, both are the
    whole key-switch's arithmetic, and neither adds bytes to it."""
    l, m = level + 1, level + 1 + alpha
    ds = cost.digits(level, alpha)
    staged = cost.ntt(n, l)
    for k in ds:
        staged = staged + cost.bconv(n, k, m - k) + cost.ntt(n, m - k)
    staged = staged + cost.pointwise(n, 2 * m, products=len(ds), adds=len(ds) - 1)
    for _ in range(2):
        staged = staged + cost.ntt(n, alpha) + cost.bconv(n, alpha, l) + cost.ntt(n, l) + cost.pointwise(
            n, l, products=1, adds=1)
    fused_ks = cost._mod_up(n, level, alpha) + cost._mac(n, level, alpha)
    fused_moddown = cost._mod_down(n, level, alpha).scaled(2)
    whole = cost.key_switch(n, level, alpha)
    for pieces in (staged, fused_ks + fused_moddown):
        assert (pieces.alu, pieces.int8) == (whole.alu, whole.int8)
    assert whole.nbytes == (l + len(ds) * 2 * m + 2 * l) * n * 4


def test_the_port_launches_differ_where_the_count_does_not():
    """At n = 2^9 the fused and staged ctx.mul launch different kernels and give the
    same ciphertext; the count has no pipeline to ask about."""
    import numpy as np
    import torch

    from repro_torch.fhe import keys as K
    from repro_torch.fhe import params as P
    from repro_torch.fhe.context import ExecPolicy, FheContext
    from repro_torch.kernels import dispatch

    p = P.make_params(512, 6, 2, check_security=False)
    ks = K.full_keyset(p, seed=0, device="cpu")
    z = np.random.default_rng(0).normal(size=p.slots) * 0.4
    outs, counts = [], []
    for backend in ("fused", "staged"):
        ctx = FheContext(params=p, keys=ks, policy=ExecPolicy(backend=backend), device="cpu")
        a = ctx.encrypt(ctx.encode(z))
        with dispatch.count_dispatches() as c:
            outs.append(ctx.mul(a, a))
        counts.append(dict(c))
    assert counts[0] != counts[1]
    assert torch.equal(outs[0].c0, outs[1].c0) and torch.equal(outs[0].c1, outs[1].c1)


def test_least_time_is_a_sum_of_operations():
    ops = [("mul", 5), ("add", 4), ("rotate_group", 6, 7)]
    assert cost.least_seconds(ops, 8192, 3) == pytest.approx(sum(cost.op(o[0], 8192, o[1], 3, *o[2:]).seconds for o in ops))


def test_a_group_of_one_counts_as_one_rotation():
    a, b = cost.op("rotate_group", 8192, 6, 3, 1), cost.op("rotate", 8192, 6, 3)
    assert (a.nbytes, a.alu, a.int8) == (b.nbytes, b.alu, b.int8)


LOLA = dict(n=8192, L=6, dnum=3, packing={"conv_n1": 14, "dense_n1": [16, 4]},
            network={"image": 28, "pad": 1, "conv": {"maps": 5, "kernel": 5, "stride": 2}, "dense": [100, 10]})


def test_lola_operations():
    ops = lola.ops(LOLA, {})
    count = lambda name: sum(1 for o in ops if o[0] == name)
    # conv: babies {1, 2}; dense 845 → 100: babies 1..15; dense 100 → 10: babies 1..3
    assert [o for o in ops if o[0] == "rotate_group"] == [("rotate_group", 6, 2), ("rotate_group", 4, 15),
                                                          ("rotate_group", 2, 3)]
    assert count("mul_plain") == 25 + 128 + 16 and count("rescale") == 3 and count("add_plain") == 3
    # giant steps: conv 9 (14, 28, 196, 210, 224, 392, 406, 588, 602), 7, 3; folds 5 and 3
    assert count("rotate") == 9 + 7 + 3 + 5 + 3
    assert [o for o in ops if o[0] == "square"] == [("square", 5), ("square", 3)]
    assert min(o[1] for o in ops) == 1


def test_eval_mod_operations():
    cfg = dict(n=65536, L=57, dnum=1, scale_bits=30, eval_mod={"K": 19, "degree": 166})
    ops = eval_mod.ops(cfg, {})
    count = lambda name: sum(1 for o in ops if o[0] == name)
    assert count("mul") == 165  # T_2 .. T_166
    assert count("add_plain") == 83  # the − 1 of every even T_j (the sine's even coefficients are 0)
    assert count("negate") == 82  # − T_1 of every odd T_j ≥ 3
    assert min(o[1] for o in ops) == 47  # the sum lands one level below T_166's
    assert cost.least_seconds(ops, 65536, 58) > 0
