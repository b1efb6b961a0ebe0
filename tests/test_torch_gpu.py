"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA card, ``nvcc`` and sm_90a (an H100): each skips inside
the ``card`` fixture where there is none.  Run them on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.fhe import keys as K
from repro_torch.fhe import ntt as nttmod
from repro_torch.fhe import params as P
from repro_torch.fhe import poly
from repro_torch.fhe.context import ExecPolicy, FheContext
from repro_torch.kernels.fusedks import ops as fops
from repro_torch.kernels.fusedks import ref as fref
from repro_torch.kernels.modops import ops as mops
from repro_torch.kernels.modops import ref as mref
from repro_torch.kernels.ntt import ops as nops
from repro_torch.kernels.ntt import ref as nref

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _residues(shape, primes, seed, device):
    rng = np.random.default_rng(seed)
    q = np.array(primes, np.uint64).reshape(-1, 1)
    a = (rng.integers(0, 1 << 31, size=shape, dtype=np.uint64) % q).astype(np.int32)
    return torch.from_numpy(a).to(device)


@pytest.mark.parametrize("shape", [(3, 8192), (2, 14, 4096), (14, 65536)], ids=str)
def test_modops_kernel_matches_plain(card, shape):
    qs = P.master_chain(shape[-2])
    a, b = _residues(shape, qs, 1, card), _residues(shape, qs, 2, card)
    before = mops.KERNEL.launches
    for kfn, pfn in ((mops.pointwise_mulmod, mref.mulmod_ref), (mops.pointwise_addmod, mref.addmod_ref),
                     (mops.pointwise_submod, mref.submod_ref)):
        assert torch.equal(kfn(a, b, qs), pfn(a, b, qs))
    c = _residues((shape[-2], 1), qs, 3, card)
    assert torch.equal(mops.pointwise_mulmod(a, c.expand(shape), qs), mref.mulmod_ref(a, c.expand(shape), qs))
    torch.cuda.synchronize()
    assert mops.KERNEL.launches == before + 4


@pytest.mark.parametrize("logn", [8, 10, 12, 13, 14, 15, 16])
def test_ntt_kernel_matches_plain(card, logn):
    n = 1 << logn
    primes = P.master_chain(3)
    plan = nttmod.build_plan(n, primes)
    x = _residues((2, 3, n), primes, logn, card)
    fwd = nops.ntt_fwd(x, plan)
    assert torch.equal(fwd, nref.ntt_fwd_ref(x, plan))
    assert torch.equal(nops.ntt_inv(x, plan), nref.ntt_inv_ref(x, plan))
    assert torch.equal(nops.ntt_inv(fwd, plan), x)


@pytest.mark.parametrize("name", ["matmul", "lstm"])
def test_fused_kernels_match_plain(card, name):
    p = P.workload_params(name)
    for level in sorted({p.L, p.alpha - 1, 1}):
        ext = poly.primes_for(p, poly.ext_idx(p, level))
        beta, m = p.beta(level), len(ext)
        d = _residues((level + 1, p.n), p.q_primes[: level + 1], level, card)
        ksk = _residues((beta * 2 * m, p.n), ext * (beta * 2), level + 1, card).reshape(beta, 2, m, p.n)
        got = fops.key_switch_digits(d, ksk, p, level)
        want = fref.key_switch_digits_ref(d, ksk, p, level)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        pc = _residues((2 * p.alpha, p.n), poly.primes_for(p, poly.p_idx(p)) * 2, 7, card).reshape(2, p.alpha, p.n)
        qpart = _residues((2 * (level + 1), p.n), p.q_primes[: level + 1] * 2, 8, card).reshape(2, level + 1, p.n)
        assert torch.equal(fops.mod_down_digits(pc, qpart, p, level), fref.mod_down_digits_ref(pc, qpart, p, level))


def test_mul_on_the_card_equals_the_cpu(card):
    p = P.make_params(1 << 9, 6, 2, check_security=False)
    z = np.random.default_rng(0).normal(size=p.slots) * 0.4
    outs = []
    for device, backend in ((card, "auto"), ("cpu", "ref")):
        ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, device=device),
                         policy=ExecPolicy(backend=backend), device=device)
        ct = ctx.encrypt(ctx.encode(z))
        outs.append(ctx.mul(ct, ct))
    assert torch.equal(outs[0].c0.cpu(), outs[1].c0) and torch.equal(outs[0].c1.cpu(), outs[1].c1)
