"""The plain NumPy reference at n = 2^9 against the port's own arithmetic: the
prime chain, the evaluation-domain layout, decryption of the port's
ciphertexts, and the two jobs' expected answers and bookkeeping (LoLa's packing
at its own size)."""

import numpy as np
import pytest
import torch

from fhebench.reference import ckks, eval_mod, lola
from repro_torch.fhe import keys as K
from repro_torch.fhe import params as P
from repro_torch.fhe import poly
from repro_torch.fhe.context import FheContext

N = 512


@pytest.fixture(scope="module")
def port():
    p = P.make_params(N, 6, 2, check_security=False)
    ks = K.full_keyset(p, seed=0, device="cpu")
    return p, ks, FheContext(params=p, keys=ks, device="cpu")


@pytest.mark.parametrize("L, dnum", [(6, 2), (6, 3), (57, 1), (13, 2)])
def test_moduli_are_the_presets(L, dnum):
    p = P.make_params(N, L, dnum, check_security=False)
    assert ckks.moduli(L, dnum) == (p.q_primes, p.p_primes)


def test_ntt_layout_matches_the_port(port):
    p, _, _ = port
    x = np.random.default_rng(1).integers(0, 1 << 29, size=(4, N))
    idx = (0, 1, 2, 3)
    ported = poly.to_eval(torch.from_numpy(x.astype(np.int32)), p, idx).numpy().astype(np.uint64)
    assert np.array_equal(ckks.ntt(x, p.q_primes[:4]), ported)
    assert np.array_equal(ckks.intt(ported, p.q_primes[:4]), x.astype(np.uint64))


def test_crt_signed_through_the_chain():
    primes = ckks.chain(8)
    v = np.random.default_rng(2).integers(-(1 << 52), 1 << 52, size=N)  # exact in float64
    assert np.array_equal(ckks.crt_signed(ckks.residues(v, primes), primes), v.astype(np.float64))


def test_a_wrong_residue_in_any_limb_is_no_small_integer():
    primes = ckks.chain(6)
    r = ckks.residues(np.arange(N) - N // 2, primes)
    r[4, 7] = (r[4, 7] + 1) % primes[4]
    got = ckks.crt_signed(r, primes)
    assert abs(got[7]) > 1e40 and np.array_equal(np.delete(got, 7), np.delete(np.arange(N) - N // 2, 7))


def test_encode_decode_round_trip():
    z = np.random.default_rng(3).normal(size=N // 2) + 1j * np.random.default_rng(4).normal(size=N // 2)
    assert np.abs(ckks.decode(ckks.encode(z, N, 2.0**30), 2.0**30) - z).max() < 1e-6


def test_decrypts_the_ports_ciphertexts(port):
    p, ks, ctx = port
    z = np.random.default_rng(0).normal(size=p.slots) * 0.4
    out = ctx.mul(ctx.encrypt(ctx.encode(z)), ctx.encrypt(ctx.encode(z), seed=5))
    got = ckks.decrypt_decode(out.c0.numpy(), out.c1.numpy(), ks.sk.s_coeff, p.q_primes[: out.level + 1], out.scale)
    assert np.array_equal(got, np.asarray(ctx.decrypt_decode(out))) or np.abs(got - z * z).max() < 5e-4
    assert np.abs(got - z * z).max() < 5e-4


def test_secret_key_encryption_and_the_control(port):
    p, ks, _ = port
    z = np.random.default_rng(6).uniform(-1, 1, size=p.slots)
    primes = p.q_primes[:3]
    good = ckks.encrypt_sk(z, ks.sk.s_coeff, primes, 2.0**30, np.random.default_rng(7))
    bad = ckks.encrypt_sk(z, ks.sk.s_coeff, primes, 2.0**30, np.random.default_rng(7), float_products=True)
    assert np.abs(ckks.decrypt_decode(*good, ks.sk.s_coeff, primes, 2.0**30) - z).max() < 1e-6
    assert not np.abs(ckks.decrypt_decode(*bad, ks.sk.s_coeff, primes, 2.0**30) - z).max() < 1e3


def _lola_cfg():
    import json

    from fhebench.harness import HERE

    return json.loads((HERE / "configs" / "lola_mnist_plain.json").read_text())


def test_lola_packing_computes_the_network():
    """The packed layers run in plain slot arithmetic (rotations as rolls) give the
    reference's logits at every slot of its output layout, at the cell's own size."""
    from fhebench import inputs
    from fhebench.jobs import lola_packing

    cfg = _lola_cfg()
    mix = {"pool": 2, "message": {"shape": ["image", "image"], "low": 0.0, "high": 1.0}}
    ins = inputs.make(cfg, mix, 2**31 + 7)
    layers = lola_packing.layers(cfg, ins["weights"])
    assert [len(x.diags) for x in layers] == [25, 128, 16] and [x.folds for x in layers][2] == [16, 32, 64]
    _, _, want = lola.expected(cfg, mix, ins)
    for image, y in zip(ins["pool"], want):
        x = lola_packing.image_slots(cfg, image)
        for j, layer in enumerate(layers):
            x = sum(u * np.roll(x, -d) for d, u in layer.diags.items())
            for r in layer.folds:
                x = x + np.roll(x, -r)
            x = x + layer.bias
            x = x * x if j + 1 < len(layers) else x
        assert np.abs(x - y).max() < 1e-12 and np.abs(y).max() > 0.1


def test_lola_reference_is_the_published_network():
    """845 convolution outputs (5 maps of 13 × 13), then 100 and 10 rows; a kernel tap
    on the padding reads zero; the bookkeeping drops five levels."""
    cfg = _lola_cfg()
    rng = np.random.default_rng(9)
    w = {x["name"]: rng.normal(size=x["shape"]) for x in cfg["weights"]}
    image = rng.uniform(size=(28, 28))
    pad = np.zeros((29, 29))
    pad[:28, :28] = image
    conv = np.array([[[np.sum(w["conv"][m] * pad[2 * r: 2 * r + 5, 2 * c: 2 * c + 5]) for c in range(13)]
                      for r in range(13)] for m in range(5)]) + w["conv.bias"][:, None, None]
    h = (w["dense.1"] @ conv.ravel() ** 2 + w["dense.1.bias"]) ** 2
    assert np.allclose(lola.logits(cfg, w, image), w["dense.2"] @ h + w["dense.2.bias"])
    level, scale, _ = lola.expected(cfg, {}, dict(weights=w, pool=[]))
    q, d = ckks.chain(7), 2.0**30
    s = d * d / q[6]
    s = s * s / q[5]
    s = s * d / q[4]
    s = s * s / q[3]
    assert (level, scale) == (1, s * d / q[2])


def test_eval_mod_levels_follow_the_ports_basis():
    from repro_torch.fhe import polyeval

    p = P.make_params(N, 14, 1, check_security=False)
    ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, device="cpu"), device="cpu")
    x = ctx.encrypt(ctx.encode(np.full(p.slots, 0.3)))
    x = ctx.mul_const_exact(x, 0.5, p.scale)
    basis = polyeval.ChebyshevBasis(ctx, x, 12)
    assert {j: ct.level for j, ct in basis.t.items()} == eval_mod.basis_levels(14, 12)
