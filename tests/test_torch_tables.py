"""Host tables of the port against the reference package: prime chains,
parameter presets, Montgomery constants, BConv tables, NTT plans, encoder.
And the one memo that keeps every table (``kernels.tables``): each registered
builder runs once per key, under its own span."""

import collections
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.fhe import encoder as R_enc
from repro.fhe import modmath as R_mm
from repro.fhe import ntt as R_ntt
from repro.fhe import params as R_P
from repro.fhe import rns as R_rns
from repro_torch.fhe import encoder as T_enc
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import modmath as T_mm
from repro_torch.fhe import ntt as T_ntt
from repro_torch.fhe import params as T_P
from repro_torch.fhe import rns as T_rns
from repro_torch.fhe.context import FheContext
from repro_torch.kernels import tables
from repro_torch.kernels.bconv import ops as T_bops
from repro_torch.kernels.fusedks import ops as T_fops
from repro_torch.kernels.modops import ops as T_mo
from repro_torch.kernels.rescale import ops as T_rsops

torch.set_num_threads(1)

CPU = "cpu"

PLAN_FIELDS = ("qs", "qinv_neg", "r2", "w_pows", "winv_pows", "psi_pows", "psiinv_ninv")


@pytest.mark.parametrize("count", [1, 4, 21, 64])
def test_master_chain_matches(count):
    assert T_P.master_chain(count) == R_P.master_chain(count)


@pytest.mark.parametrize("name", sorted(R_P.WORKLOAD_PRESETS))
def test_workload_presets_match_field_by_field(name):
    assert T_P.WORKLOAD_PRESETS[name] == R_P.WORKLOAD_PRESETS[name]
    tp, rp = T_P.workload_params(name), R_P.workload_params(name)
    assert dataclasses.asdict(tp) == dataclasses.asdict(rp)
    for attr in ("scheme", "alpha", "slots", "scale", "all_primes", "log_pq", "num_digits"):
        assert getattr(tp, attr) == getattr(rp, attr), attr
    assert tp.check_security() == rp.check_security()
    assert [tp.beta(lv) for lv in range(tp.L + 1)] == [rp.beta(lv) for lv in range(rp.L + 1)]
    assert [tp.digit(j) for j in range(tp.num_digits)] == [rp.digit(j) for j in range(rp.num_digits)]


def test_preset_groups_and_make_params_errors_match():
    assert T_P.SHALLOW_WORKLOADS == R_P.SHALLOW_WORKLOADS
    assert T_P.DEEP_WORKLOADS == R_P.DEEP_WORKLOADS
    assert T_P.BGV_WORKLOADS == R_P.BGV_WORKLOADS
    with pytest.raises(ValueError):
        T_P.make_params(1 << 12, 40, 1)
    with pytest.raises(ValueError):
        T_P.make_params(1 << 9, 2, 1, check_security=False, plain_modulus=3)


def test_prime_generation_and_roots_match():
    two_n = 2 << 16
    assert T_mm.gen_ntt_primes(30, 6, two_n) == R_mm.gen_ntt_primes(30, 6, two_n)
    assert T_mm.gen_ntt_primes(26, 4, two_n) == R_mm.gen_ntt_primes(26, 4, two_n)
    for q in T_mm.gen_ntt_primes(30, 3, two_n):
        assert T_mm.is_prime(q) and (q - 1) % two_n == 0
        for logn in (4, 9, 16):
            assert T_mm.root_of_unity(2 << logn, q) == R_mm.root_of_unity(2 << logn, q)
    assert [T_mm.is_prime(v) for v in range(200)] == [R_mm.is_prime(v) for v in range(200)]


def test_mont_constants_match():
    qs = T_P.master_chain(21) + (3,)
    t, r = T_mm.mont_constants_array(qs), R_mm.mont_constants_array(qs)
    assert t.keys() == r.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], r[k])
        assert t[k].dtype == np.uint32


@pytest.mark.parametrize("k,m", [(1, 3), (2, 7), (7, 21), (4, 9)])
def test_bconv_tables_match(k, m):
    chain = T_P.master_chain(k + m)
    src, dst = chain[:k], chain[k:]
    tb, tw = T_rns.bconv_tables(src, dst)
    rb, rw = R_rns.bconv_tables(src, dst)
    np.testing.assert_array_equal(tb, rb)
    np.testing.assert_array_equal(tw, rw)
    assert T_rns.product(src) == R_rns.product(src)


@pytest.mark.parametrize("logn", [8, 9, 10, 11])
def test_ntt_plan_ref_tables_match(logn):
    n = 1 << logn
    primes = T_P.master_chain(5)
    tplan, rplan = T_ntt.build_plan(n, primes), R_ntt.build_plan(n, primes)
    assert tplan.n == rplan.n and tplan.num_limbs == rplan.num_limbs
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tplan, f), getattr(rplan, f), err_msg=f)
    idx = (0, 2, 4)
    tsub, rsub = T_ntt.subplan(n, primes, idx), R_ntt.subplan(n, primes, idx)
    assert tsub.primes == tuple(primes[i] for i in idx)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tsub, f), getattr(rsub, f), err_msg=f)
    np.testing.assert_array_equal(T_ntt.bit_reverse_indices(n), R_ntt.bit_reverse_indices(n))


def test_ntt_plan_keeps_only_the_butterfly_tables():
    """The MXU limb matrices of the TPU kernel are not built (88 MB at lstm)."""
    names = {f.name for f in dataclasses.fields(T_ntt.NttPlan)}
    assert names == {"n", "primes", *PLAN_FIELDS}


@pytest.mark.parametrize("logn", [9, 13])
def test_encoder_matches(logn):
    n = 1 << logn
    primes = T_P.master_chain(3)
    z = np.random.default_rng(logn).normal(size=n // 2) * 0.4
    scale = 2.0**30
    t, r = T_enc.encode(z, n, scale, primes), R_enc.encode(z, n, scale, primes)
    np.testing.assert_array_equal(t, r)
    np.testing.assert_array_equal(T_enc.encode_const(0.7, n, scale, primes), R_enc.encode_const(0.7, n, scale, primes))
    np.testing.assert_array_equal(T_enc.decode(t, primes, scale), R_enc.decode(r, primes, scale))
    assert np.max(np.abs(T_enc.decode(t, primes, scale) - z)) < T_enc.max_encode_error(n, scale)


def _every_table(ctx):
    """Build every table of the port on the CPU: a fused and a staged mul
    (rescale included), a rotation and a real constant; then the card's
    tables, built here for the CPU."""
    p, cpu = ctx.params, torch.device(CPU)
    a = ctx.encrypt(ctx.encode(np.random.default_rng(0).uniform(-0.5, 0.5, size=p.slots)))
    for backend in ("fused", "staged"):
        c = ctx.with_policy(backend=backend)
        c.add_const(c.rotate(c.mul(a, a), 1), 0.5)
    T_fops.ks_tables(p, p.L, cpu)
    T_fops.moddown_tables(p, p.L, cpu)
    T_rsops.tables(p, p.L, cpu)
    T_mo.constants(p.q_primes, cpu)
    _, _, dst, _, w = T_rns.digit_tables(p, p.L, 0)
    T_bops.device_table(np.asarray(w, np.uint64).tobytes(), len(w), dst, cpu)


@pytest.fixture(scope="module")
def cold_build(tmp_path_factory):
    """From no table at all: the ``fhe.table.*`` spans of one ``_every_table``
    run, and every builder's cache_info after it and after a second run."""
    p = T_P.make_params(1 << 9, 4, 2, check_security=False)
    ctx = FheContext(params=p, keys=T_K.full_keyset(p, seed=0, rotations=(1,), conjugate=False, device=CPU),
                     device=CPU)
    tables.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _every_table(ctx)
    path = tmp_path_factory.mktemp("tables") / "cold.json"
    prof.export_chrome_trace(str(path))
    spans = collections.Counter(e["name"] for e in json.loads(path.read_text())["traceEvents"]
                                if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    first = {name: f.cache_info() for name, f in tables.registry().items()}
    _every_table(ctx)
    second = {name: f.cache_info() for name, f in tables.registry().items()}
    return spans, first, second


@pytest.mark.parametrize("name", sorted(tables.registry()))
def test_each_table_is_built_once_a_key_under_its_span(cold_build, name):
    spans, first, second = cold_build
    info = first[name]
    assert info.misses == info.currsize > 0  # built, and once for each key
    assert spans[f"fhe.table.{name}"] == info.misses
    assert second[name].misses == info.misses  # the second run builds nothing
    assert info.maxsize is None  # no bound: no table is ever freed


def test_table_names_are_unique_and_a_second_registration_raises():
    names = list(tables.registry())
    assert len(names) == len(set(names)) >= 15
    with pytest.raises(ValueError, match="already registered"):
        tables.table(names[0])
    assert tables.builds() == sum(f.cache_info().misses for f in tables.registry().values())


@dataclasses.dataclass
class _Held:
    rows: list


@pytest.mark.parametrize("out", [torch.zeros(2), (1, np.zeros(2)), [torch.zeros(1)], {"a": (torch.zeros(1),)},
                                 _Held([np.uint32(3), torch.zeros(1)]), None])
def test_table_results_are_walked_for_cuda_tensors(out):
    assert tables._cuda_device(out) is None  # CPU tensors only: nothing to synchronise


def test_a_table_result_the_walker_cannot_look_inside_raises():
    with pytest.raises(TypeError, match="cannot look inside"):
        tables._cuda_device([{"a": object()}])
