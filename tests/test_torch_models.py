"""The port's LM layers and models (``repro_torch.models``) against the
reference's (``repro.models``), on the CPU.

The same numpy-seeded inputs go through both.  The reference's parameters
are carried into the port by ``params_from_reference``.  Each comparison
states its bound, |port − reference| ≤ atol + rtol·|reference|, and a
correlation floor; every bound is far inside the reference's own
prefill/decode consistency bound (atol 0.55, rtol 0.15, corr > 0.98,
``tests/test_arch_smoke.py``).  Norms, rotary embedding, attention, the SSD
output and the convolution agree to one bfloat16 ulp on bfloat16-valued
inputs, most of them bit for bit; the activations (``silu``, tanh ``gelu``)
round once where XLA rounds differently, one ulp of their output.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro.models import registry as ref_registry
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)

ARCHS = configs.ARCH_IDS


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the SMOKE archs' inputs and bounds are chip_smoke.py's, which holds the
# card to the port's CPU path with them (measured maxima against the
# reference in PERF.md: logits 0.053, bf16 caches 0.035, SSM state 0.079)
CS = _chip_smoke()
LOSS_ATOL = 0.02  # measured 0.011
ULP = dict(atol=1e-6, rtol=2**-7)  # one bfloat16 ulp


def _bf16(a) -> np.ndarray:
    """float32 numpy values rounded to bfloat16 values."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _j(a, dtype=jnp.bfloat16):
    return jnp.asarray(np.asarray(a), dtype)


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(ref, got, atol=0.0, rtol=0.0, corr=None, where=None):
    """Assert |got − ref| ≤ atol + rtol·|ref| (on ``where`` if given) and the
    correlation floor; returns the max abs difference."""
    r, g = _np(ref), _np(got)
    assert r.shape == g.shape, (r.shape, g.shape)
    if where is not None:
        r, g = r[where], g[where]
    np.testing.assert_allclose(g, r, atol=atol, rtol=rtol)
    if corr is not None and r.size > 1:
        assert np.corrcoef(r.ravel(), g.ravel())[0, 1] > corr
    return float(np.abs(r - g).max(initial=0.0))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((2, 9, 40)))
    w = _bf16(1 + 0.1 * rng.standard_normal(40))
    b = _bf16(0.1 * rng.standard_normal(40))
    close(RL.rmsnorm(_j(x), _j(w)), L.rmsnorm(_t(x), _t(w)), **ULP)
    close(RL.layernorm(_j(x), _j(w), _j(b)), L.layernorm(_t(x), _t(w), _t(b)), **ULP)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = _bf16(rng.standard_normal((2, 9, 3, 16)))
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    got = L.rope(_t(x), torch.from_numpy(pos), 10000.0)
    assert got.dtype == torch.bfloat16
    close(RL.rope(_j(x), jnp.asarray(pos), 10000.0), got, **ULP)


def _qkv(seed, sq=37, sk=37, h=6, kv=2, d=16):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.standard_normal((2, sq, h, d))), _bf16(rng.standard_normal((2, sk, kv, d))),
            _bf16(rng.standard_normal((2, sk, kv, d))))


FLASH_CASES = {
    "causal, one chunk": dict(),
    "causal, ragged chunks": dict(q_chunk=8, k_chunk=16),
    "sliding window": dict(q_chunk=8, k_chunk=16, window=12),
    "bidirectional": dict(causal=False, q_chunk=8, k_chunk=16),
    "continuation at q_offset": dict(q_chunk=8, k_chunk=16, q_offset=32, sq=5),
    "cross attention": dict(causal=False, sq=11, k_chunk=8),
}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    kw = dict(FLASH_CASES[case])
    q, k, v = _qkv(2, sq=kw.pop("sq", 37))
    ref = RL.flash_attention(_j(q), _j(k), _j(v), **kw)
    close(ref, L.flash_attention(_t(q), _t(k), _t(v), **kw), **ULP)


@pytest.mark.parametrize("window", [0, 12])
def test_flash_attention_under_block_skipping(window):
    q, k, v = _qkv(3)
    kw = dict(q_chunk=8, k_chunk=8, window=window)
    with RL.causal_block_skipping(), L.causal_block_skipping():
        ref = RL.flash_attention(_j(q), _j(k), _j(v), **kw)
        got = L.flash_attention(_t(q), _t(k), _t(v), **kw)
    close(ref, got, **ULP)
    # skipped blocks are fully masked: the unskipped loop gives the same bits
    assert torch.equal(got, L.flash_attention(_t(q), _t(k), _t(v), **kw))


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_matches_reference(window):
    q, k, v = _qkv(4, sq=1, sk=40)
    close(RL.decode_attention(_j(q), _j(k), _j(v), 29, window=window),
          L.decode_attention(_t(q), _t(k), _t(v), torch.tensor(29, dtype=torch.int32), window=window), **ULP)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ffn_matches_reference(act):
    rng = np.random.default_rng(5)
    x = _bf16(rng.standard_normal((2, 9, 40)))
    w1, w3 = (_bf16(rng.standard_normal((40, 64)) / np.sqrt(40)) for _ in range(2))
    w2 = _bf16(rng.standard_normal((64, 40)) / 8)
    w3j, w3t = (_j(w3), _t(w3)) if act == "swiglu" else (None, None)
    # one bfloat16 ulp of the activation (silu, tanh gelu) at most
    close(RL.ffn(_j(x), _j(w1), _j(w2), w3j, act=act), L.ffn(_t(x), _t(w1), _t(w2), w3t, act=act),
          atol=0.02, rtol=0.01, corr=0.9999)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_ffn_matches_reference_with_dropped_tokens(n_shared):
    rng = np.random.default_rng(6)
    t, d, e, f, k = 96, 40, 8, 32, 2
    x = _bf16(rng.standard_normal((t, d)))
    shapes = [(d, e), (e, d, f), (e, f, d), (e, d, f), (d, 2 * f), (2 * f, d), (d, 2 * f)]
    ws = [(rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32) for s in shapes]
    shared = dict(zip(("sw1", "sw2", "sw3"), ws[4:])) if n_shared else {}
    cf = 0.75  # capacity int(0.75·k·t/e) + 1 = 19 rows an expert: several overflow
    ref, ref_probs = RL.moe_ffn(_j(x), *map(jnp.asarray, ws[:4]), top_k=k, capacity_factor=cf,
                                n_shared=n_shared, **{n: jnp.asarray(w) for n, w in shared.items()})
    got, probs = L.moe_ffn(_t(x), *map(torch.from_numpy, ws[:4]), top_k=k, capacity_factor=cf,
                           n_shared=n_shared, **{n: torch.from_numpy(w) for n, w in shared.items()})
    counts = np.bincount(np.asarray(jax.lax.top_k(ref_probs, k)[1]).ravel(), minlength=e)
    assert np.maximum(counts - (int(cf * k * t / e) + 1), 0).sum() >= 10  # tokens dropped
    assert torch.equal(torch.topk(probs, k).indices, torch.from_numpy(np.asarray(jax.lax.top_k(ref_probs, k)[1])).long())
    close(ref_probs, probs, atol=1e-6)
    close(ref, got, atol=0.04, rtol=0.01, corr=0.9999)  # ≈ one bfloat16 ulp


def _ssd_inputs(seed, b=2, s=37, nh=4, hd=8, ns=6):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(xh=f32(rng.standard_normal((b, s, nh, hd))), dt=f32(np.log1p(np.exp(rng.standard_normal((b, s, nh))))),
                a_log=f32(0.5 * rng.standard_normal(nh)), b_in=f32(rng.standard_normal((b, s, ns))),
                c_in=f32(rng.standard_normal((b, s, ns))), d_skip=f32(rng.standard_normal(nh))), \
        f32(rng.standard_normal((b, nh, hd, ns)))


def test_ssd_chunked_with_h0_and_a_ragged_last_chunk():
    inp, h0 = _ssd_inputs(7)  # 37 steps in chunks of 16
    ry, rh = RL.ssd_chunked(*(_j(a, jnp.float32) for a in inp.values()), chunk=16, h0=_j(h0, jnp.float32))
    ty, th = L.ssd_chunked(*(torch.from_numpy(a) for a in inp.values()), chunk=16, h0=torch.from_numpy(h0))
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    close(ry, ty, atol=1e-6, rtol=1e-2)  # bfloat16 output
    close(rh, th, atol=1e-5, rtol=1e-5)


def test_ssd_decode_step_matches_reference():
    inp, h = _ssd_inputs(8, s=1)
    one = {k: (a[:, 0] if a.ndim > 1 else a) for k, a in inp.items()}
    ry, rh = RL.ssd_decode_step(*(_j(a, jnp.float32) for a in one.values()), _j(h, jnp.float32))
    ty, th = L.ssd_decode_step(*(torch.from_numpy(a) for a in one.values()), torch.from_numpy(h))
    close(ry, ty, atol=1e-6, rtol=1e-2)
    close(rh, th, atol=1e-5, rtol=1e-5)


def test_causal_conv1d_full_and_streaming():
    rng = np.random.default_rng(9)
    x = _bf16(rng.standard_normal((2, 9, 12)))
    w = (0.5 * rng.standard_normal((12, 4))).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    ry, rs = RL.causal_conv1d(_j(x), jnp.asarray(w), jnp.asarray(b))
    ty, ts = L.causal_conv1d(_t(x), torch.from_numpy(w), torch.from_numpy(b))
    close(ry, ty, atol=1e-6, rtol=1e-6)
    close(rs, ts)
    # streaming: one token at a time from a zero state gives the full output
    state = torch.zeros((2, 3, 12), dtype=torch.bfloat16)
    rstate = jnp.zeros((2, 3, 12), jnp.bfloat16)
    for i in range(x.shape[1]):
        ry1, rstate = RL.causal_conv1d(_j(x[:, i:i + 1]), jnp.asarray(w), jnp.asarray(b), state=rstate)
        ty1, state = L.causal_conv1d(_t(x[:, i:i + 1]), torch.from_numpy(w), torch.from_numpy(b), state=state)
        close(ry1, ty1, atol=1e-6, rtol=1e-6)
        close(ty[:, i:i + 1], ty1, atol=1e-6, rtol=1e-6)
    close(rstate, state)


# ---------------------------------------------------------------------------
# the ten archs at SMOKE size
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(arch: str, smoke: bool = True):
    """(reference cfg, api, params; port cfg, api, params) at the same weights."""
    rcfg, cfg = ref_configs.get_config(arch, smoke=smoke), configs.get_config(arch, smoke=smoke)
    rapi, api = ref_registry.build(rcfg), registry.build(cfg)
    rparams = rapi.init_params(jax.random.PRNGKey(0))
    params = params_from_reference(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, rapi, rparams, cfg, api, params


def _near_ties(rcfg, rparams, tokens) -> np.ndarray:
    """(B, S) mask of the positions whose first-layer router gap in the
    reference is below ``chip_smoke.MOE_MARGIN`` (all False for a dense model)."""
    b, s = tokens.shape
    if not rcfg.is_moe:
        return np.zeros((b, s), bool)
    p0 = jax.tree.map(lambda a: a[0], rparams["blocks"])
    x = ref_lm.embed(rcfg, rparams, jnp.asarray(tokens))
    h = x + ref_lm.attn_forward(rcfg, p0["attn"], x, jnp.broadcast_to(jnp.arange(s), (b, s)), window=0)
    hn = RL.rmsnorm(h, p0["ffn_ln"].astype(h.dtype)).astype(jnp.float32)
    probs = np.sort(np.asarray(jax.nn.softmax(hn @ p0["moe"]["router"], axis=-1)), axis=-1)[..., ::-1]
    return probs[..., rcfg.top_k - 1] - probs[..., rcfg.top_k] < CS.MOE_MARGIN


def _close_cache(cfg, rc, tc, ties):
    """Every cache tensor against the reference's under ``chip_smoke``'s
    bounds; the layers after a MoE layer skip its near-tie positions."""
    ref = {k: torch.from_numpy(np.array(v.astype(jnp.float32) if k != "t" else v)) for k, v in rc.items()}
    res = CS.compare_caches(cfg, ref, tc, ties)
    assert all(v[2] for v in res.values()), res


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_arch_matches_reference(arch):
    """prefill logits and every cache tensor, one decode step, and the loss."""
    rcfg, rapi, rparams, cfg, api, params = _pair(arch)
    b, s, smax = 2, 48, 64
    batch = CS.smoke_inputs(cfg, b, s)
    token = batch.pop("token")
    rc = rapi.init_cache(b, smax)
    rl, rc = jax.jit(lambda p, c, **kw: rapi.prefill(p, c, **kw))(rparams, rc, **{k: jnp.asarray(v) for k, v in batch.items()})
    tc = api.init_cache(b, smax, device="cpu")
    tl, tc = api.prefill(params, tc, **{k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tc) == set(rc) and int(tc["t"]) == int(rc["t"]) and tc["t"].dtype == torch.int32
    for k in tc:
        assert tuple(tc[k].shape) == rc[k].shape and str(tc[k].dtype).split(".")[-1] == str(rc[k].dtype), k
    close(rl, tl, **CS.SMOKE_TOL["logits"])
    ties = _near_ties(rcfg, rparams, np.concatenate([batch["tokens"], token[:, None]], 1))
    _close_cache(cfg, rc, tc, ties[:, :-1])
    rl, rc = jax.jit(rapi.decode_step)(rparams, jnp.asarray(token), rc)
    tl, tc = api.decode_step(params, torch.from_numpy(token), tc)
    close(rl, tl, **CS.SMOKE_TOL["logits"])
    _close_cache(cfg, rc, tc, ties)
    batch = CS.smoke_inputs(cfg, b, s + 1)  # one more token: the targets
    batch.pop("token")
    ref_loss = jax.jit(lambda p, **kw: rapi.train_loss(p, **kw))(rparams, **{k: jnp.asarray(v) for k, v in batch.items()})
    loss = api.train_loss(params, **{k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - float(ref_loss)) < LOSS_ATOL


def test_moe_near_ties_are_few():
    """The MoE cache comparisons above leave out only a handful of positions."""
    for arch in ("moonshot-v1-16b-a3b", "deepseek-moe-16b"):
        rcfg, _, rparams, cfg, _, _ = _pair(arch)
        toks = CS.smoke_inputs(cfg, 2, 48)["tokens"]
        assert 0 < _near_ties(rcfg, rparams, toks).sum() <= 6


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b", "hymba-1.5b"])
def test_prefill_decode_consistency(arch):
    """decode-after-prefill matches an all-at-once prefill (teacher forcing),
    as the reference's own test checks it, to a far tighter bound."""
    cfg = configs.get_config(arch, smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (1, 17), dtype=np.int32))
    full, _ = api.prefill(params, api.init_cache(1, 32, device="cpu"), tokens=toks)
    _, cache = api.prefill(params, api.init_cache(1, 32, device="cpu"), tokens=toks[:, :16])
    step, _ = api.decode_step(params, toks[:, 16], cache)
    close(full, step, atol=0.05, rtol=0.02, corr=0.999)  # the reference allows 0.55, 0.15, 0.98


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_layout_match_reference(arch):
    """``param_count`` of the full config, and the port's own init at SMOKE
    size: the reference's tree layout, shapes and scales."""
    for smoke in (False, True):
        rcfg, cfg = ref_configs.get_config(arch, smoke=smoke), configs.get_config(arch, smoke=smoke)
        assert cfg == type(cfg)(**vars(rcfg))
        assert cfg.param_count() == rcfg.param_count()
        assert cfg.active_param_count() == rcfg.active_param_count()
    _, _, rparams, cfg, api, params = _pair(arch)
    own = dict(api.init_params(1, device="cpu").named_parameters())
    carried = dict(params.named_parameters())
    assert own.keys() == carried.keys()
    for name, p in own.items():
        assert p.shape == carried[name].shape and p.dtype == torch.float32, name
        if p.numel() >= 1024:  # a random weight: the reference's scale within 10%
            assert abs(float(p.std()) / float(carried[name].std()) - 1) < 0.1, name
    assert sum(p.numel() for p in own.values()) == sum(a.size for a in jax.tree.leaves(rparams))


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        api.init_params(0)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        api.init_cache(1, 8)
    tree = jax.tree.map(np.asarray, ref_registry.build(ref_configs.get_config("smollm-135m", smoke=True))
                        .init_params(jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        params_from_reference(cfg, tree)
