"""The port's training path (``repro_torch.training``) against the
reference's (``repro.training``), on the CPU.

The same numpy-seeded batches go through both; the reference's parameters
are carried into the port by ``params_from_reference`` and the port's back
by ``params_to_reference``.  Bounds of one train step (``chip_smoke.py``
holds the card to the port's CPU path with the same ``TRAIN_TOL``): the
loss within 0.011, the serving checks' SMOKE loss gap (measured ≤ 1e-4 at
smollm), the gradient norm within 1e-2 relative (measured 3e-5), and the
AdamW update d = w_new − w0 weight by weight (``chip_smoke.update_gap``).
The two packages' gradients differ by up to 3.8% of a leaf's largest (two
bfloat16 forward passes), so a weight whose reference gradient lies below
5% of its leaf's largest is a near-tie, held only to 2·lr (a sign flip of
the first step's ≈ ±lr); every other weight, 62% of them, is held to
1e-3·lr plus two float32 roundings (2^-22·|w|).  Sound runs read at most
3.5e-6·lr there; planted faults in a copy of the optimizer read 1.10·lr
(the update left out), 0.553·lr (the bias correction left out) and
0.550·lr (half the learning rate).  AdamW alone, on identical inputs at
its first, second and eighth step (at the second and later m̂/√v̂ is no
longer sign g), holds every weight to 1e-3·lr: sound runs read at most
2.4e-7·lr, the same planted faults at least 0.017·lr (the bias correction
left out at step 8, where it is 1 − 0.9^8), and its moments to 2^-19 of
the leaf's largest (measured 4.0e-7).  After one train step the moments
follow the gradients: per leaf a correlation above 0.998 (measured
≥ 0.99890) and a largest gap of 0.1 of the leaf's largest entry (measured
0.051).  The learning-rate schedule is the reference's float32 arithmetic,
bit for bit through the warm-up; its cosine comes from another
implementation (torch's ``cos``, not XLA's, and neither is correctly
rounded), so the decay lands within 2^-22 of the peak rate of the
reference's (measured 2^-23.6), a few float32 ulps of the small rates.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as ref_configs
from repro.models import registry as ref_registry
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_ts
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference, params_to_reference, tree_from_reference
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

torch.set_num_threads(1)

ACFG = dict(lr_peak=3e-3, warmup_steps=5, total_steps=40)
LOSS_ATOL = 0.011  # the largest SMOKE loss gap measured in tests/test_torch_models.py
GNORM_RTOL = 1e-2


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
TOL = CS.TRAIN_TOL  # tie 0.05, update_lr 1e-3, params_lr 2.0, params_rtol 2^-22


@pytest.fixture(autouse=True)
def _reference_in_float32():
    """The reference runs as it does alone, without JAX's x64 mode, which
    another test file in the same worker may have turned on."""
    with jax.enable_x64(False):
        yield


def _pair(arch="smollm-135m"):
    rcfg, cfg = ref_configs.get_config(arch, smoke=True), configs.get_config(arch, smoke=True)
    rapi, api = ref_registry.build(rcfg), registry.build(cfg)
    rparams = rapi.init_params(jax.random.PRNGKey(0))
    return rapi, rparams, cfg, api, params_from_reference(cfg, jax.tree.map(np.asarray, rparams), device="cpu")


def _tokens(cfg, b=8, s=32):
    return pipeline.synthetic_lm_batch(0, 0, b, s, cfg.vocab)


def _ref_step(rapi, rparams, tokens, microbatch=0):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    step = ref_ts.build_train_step(rapi, mesh, ref_opt.AdamWConfig(**ACFG), microbatch=microbatch)
    return jax.jit(step)(rparams, ref_opt.init_state(rparams), {"tokens": jnp.asarray(tokens, jnp.int32)})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_update_close(w0, ref_new, got_new, ref_m, lr, share=0.5):
    """The update of every weight that is no near-tie within update_lr·lr of
    the reference's, every weight within params_lr·lr, and at least
    ``share`` of the weights held to the first bound."""
    L = jax.tree.leaves
    up = CS.update_gap(L(w0), L(ref_new), L(got_new), L(ref_m), lr)
    assert up["kept"] <= TOL["update_lr"], up
    assert up["all"] <= TOL["params_lr"], up
    assert up["share"] >= share, up


def test_adamw_reduces_loss():
    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    acfg = opt.AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=40)
    state = opt.init_state(params)
    corpus = pipeline.ByteCorpus(vocab=cfg.vocab)
    losses = []
    for i in range(30):
        batch = torch.from_numpy(corpus.batch(seed=1, step=i, batch=8, seq=32))
        loss, grads = ts.loss_and_grads(api, params, {"tokens": batch})
        params, state, _ = opt.apply_updates(acfg, params, grads, state)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses[:3] + losses[-3:]


@pytest.mark.parametrize("cfg", [dict(lr_peak=1e-3, warmup_steps=10, total_steps=100), ACFG,
                                 dict(lr_peak=3e-3, warmup_steps=15, total_steps=300), {}], ids=str)
def test_lr_schedule_matches_reference(cfg):
    """Steps 0–120 in float32: bit for bit through the warm-up, within
    2^-22·lr_peak of the reference's after it; the reference test's checks."""
    rcfg, tcfg = ref_opt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    ref = np.array([np.asarray(ref_opt.lr_at(rcfg, jnp.asarray(s, jnp.int32))) for s in range(121)])
    got = np.array([opt.lr_at(tcfg, torch.tensor(s, dtype=torch.int32)).numpy() for s in range(121)])
    assert ref.dtype == got.dtype == np.float32
    assert np.array_equal(ref[: tcfg.warmup_steps], got[: tcfg.warmup_steps])
    assert np.abs(ref.astype(np.float64) - got).max() <= 2**-22 * tcfg.lr_peak
    if cfg == dict(lr_peak=1e-3, warmup_steps=10, total_steps=100):
        assert float(opt.lr_at(tcfg, 0)) < float(opt.lr_at(tcfg, 9))
        assert float(opt.lr_at(tcfg, 10)) == pytest.approx(1e-3, rel=0.01)
        assert float(opt.lr_at(tcfg, 99)) < 1e-4


def test_grad_accumulation_equivalence():
    """microbatched gradients == full-batch gradients (linearity of mean)."""
    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg))
    state = opt.init_state(params)
    p1, _, m1 = ts.build_train_step(api, None, opt.AdamWConfig(), microbatch=0)(params, state, {"tokens": tokens})
    p4, _, m4 = ts.build_train_step(api, None, opt.AdamWConfig(), microbatch=4)(params, state, {"tokens": tokens})
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-2
    assert max(float((a - b).abs().max()) for a, b in zip(opt.tree_leaves(p1), opt.tree_leaves(p4))) < 5e-3


@pytest.mark.parametrize("microbatch", [0, 4])
def test_train_step_matches_reference(microbatch):
    """One step against ``repro``'s ``build_train_step`` on a one-device mesh:
    loss, gradient norm, lr, the weights, both moments and the step count."""
    rapi, rparams, cfg, api, params = _pair()
    tokens = _tokens(cfg)
    rp, rs, rm = _ref_step(rapi, rparams, tokens, microbatch)
    step = ts.build_train_step(api, None, opt.AdamWConfig(**ACFG), microbatch=microbatch)
    p, s, m = step(params, opt.init_state(params), {"tokens": torch.from_numpy(tokens)})
    assert all(v.dtype == torch.float32 and v.shape == () for v in m.values())
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_ATOL
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= GNORM_RTOL * float(rm["grad_norm"])
    assert float(m["lr"]) == float(rm["lr"])
    lr0 = float(opt.lr_at(opt.AdamWConfig(**ACFG), 0))
    _assert_update_close(rparams, rp, params_to_reference(cfg, p), rs["m"], lr0)
    # m = (1 − b1)·g and v = (1 − b2)·g² of the clipped gradients
    for k in ("m", "v"):
        for r, g in zip(jax.tree.leaves(rs[k]), jax.tree.leaves(params_to_reference(cfg, s[k]))):
            r = np.asarray(r)
            assert np.corrcoef(r.ravel(), g.ravel())[0, 1] > 0.998
            assert np.abs(g - r).max() <= 0.1 * np.abs(r).max()
    assert s["step"].dtype == torch.int32 and int(s["step"]) == int(rs["step"]) == 1


@pytest.mark.parametrize("steps", [1, 2, 8])
def test_apply_updates_matches_reference(steps):
    """AdamW alone at its ``steps``-th step, the port against the reference on
    identical inputs: the weights, the moments and the step count from the
    reference's earlier steps, and the same gradients, drawn so that the
    global norm falls either side of ``clip_norm``.  Every weight's update
    within update_lr·lr of the reference's; the moments within 2^-19 of
    the leaf's largest; the gradient norm, the step count and the dtypes."""
    rcfg, cfg = ref_configs.get_config("smollm-135m", smoke=True), configs.get_config("smollm-135m", smoke=True)
    racfg, acfg = ref_opt.AdamWConfig(**ACFG), opt.AdamWConfig(**ACFG)
    w = _np_tree(ref_registry.build(rcfg).init_params(jax.random.PRNGKey(0)))
    state = ref_opt.init_state(w)
    rng = np.random.default_rng(steps)
    for k in range(steps):
        scale = 10.0 ** rng.uniform(-3.0, -1.0)  # global norm 0.24 to 24
        grads = jax.tree.map(lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32), w)
        if k < steps - 1:
            w, state, _ = ref_opt.apply_updates(racfg, w, grads, state)
            w = _np_tree(w)
    rw, rs, rgn = ref_opt.apply_updates(racfg, w, grads, state)
    pstate = {k: tree_from_reference(cfg, _np_tree(state[k]), "cpu") for k in ("m", "v")}
    pstate["step"] = torch.tensor(int(state["step"]), dtype=torch.int32)
    pw, ps, pgn = opt.apply_updates(acfg, params_from_reference(cfg, w, device="cpu"),
                                    tree_from_reference(cfg, grads, "cpu"), pstate)
    up = CS.update_gap(jax.tree.leaves(w), jax.tree.leaves(rw), jax.tree.leaves(params_to_reference(cfg, pw)),
                       jax.tree.leaves(grads), float(opt.lr_at(acfg, steps - 1)))
    assert up["all"] <= TOL["update_lr"], up
    for k in ("m", "v"):
        for r, g in zip(jax.tree.leaves(rs[k]), jax.tree.leaves(params_to_reference(cfg, ps[k]))):
            r = np.asarray(r, np.float64)
            assert np.abs(g - r).max() <= 2**-19 * np.abs(r).max()
    assert float(pgn) == pytest.approx(float(rgn), rel=1e-6)
    assert ps["step"].dtype == torch.int32 and int(ps["step"]) == int(rs["step"]) == steps


def test_grads_keep_param_dtypes():
    """The gradients and the updated weights keep each weight's dtype (a
    bfloat16 leaf among float32 ones), with and without microbatches; the
    moments are float32 and the loss a float32 scalar."""
    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    params.final_ln = torch.nn.Parameter(params["final_ln"].detach().to(torch.bfloat16))
    tokens = {"tokens": torch.from_numpy(_tokens(cfg))}
    for mb in (0, 4):
        loss, grads = ts.loss_and_grads(api, params, tokens, microbatch=mb)
        assert loss.dtype == torch.float32 and loss.shape == ()
        assert [g.dtype for g in opt.tree_leaves(grads)] == [p.dtype for p in opt.tree_leaves(params)]
        new, state, _ = opt.apply_updates(opt.AdamWConfig(), params, grads, opt.init_state(params))
        assert [g.dtype for g in opt.tree_leaves(new)] == [p.dtype for p in opt.tree_leaves(params)]
        assert {t.dtype for k in ("m", "v") for t in opt.tree_leaves(state[k])} == {torch.float32}
    assert new["final_ln"].dtype == torch.bfloat16 and new["final_ln"].requires_grad


def test_apply_updates_leaves_its_inputs_alone():
    """Functional, as the reference: the inputs keep their values; the new
    weights are trainable leaves, the moments are not."""
    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    before = [p.detach().clone() for p in opt.tree_leaves(params)]
    state = opt.init_state(params)
    _, grads = ts.loss_and_grads(api, params, {"tokens": torch.from_numpy(_tokens(cfg))})
    new, new_state, gnorm = opt.apply_updates(opt.AdamWConfig(lr_peak=1e-2, warmup_steps=1), params, grads, state)
    assert all(torch.equal(a, b) for a, b in zip(before, opt.tree_leaves(params)))
    assert all(float(t.abs().max()) == 0 for k in ("m", "v") for t in opt.tree_leaves(state[k]))
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert all(p.is_leaf and p.requires_grad for p in opt.tree_leaves(new))
    assert not any(t.requires_grad for t in opt.tree_leaves(new_state["m"]))
    assert float(gnorm) == pytest.approx(float(opt.global_norm(grads)))
    assert any(not torch.equal(a, b) for a, b in zip(before, opt.tree_leaves(new)))


def test_build_train_step_refuses_what_it_does_not_do():
    api = registry.build(configs.get_config("smollm-135m", smoke=True))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ts.build_train_step(api, object(), opt.AdamWConfig())
    with pytest.raises(ValueError, match="group"):
        ts.build_train_step(api, None, opt.AdamWConfig(), compress_pods=True)


def test_remat_gives_the_same_gradients():
    """Checkpointing each block (the default) recomputes its inside in the
    backward pass: the gradients equal those without remat, bit for bit."""
    from repro_torch.models import lm

    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    tokens = {"tokens": torch.from_numpy(_tokens(cfg))}
    _, with_remat = ts.loss_and_grads(api, params, tokens)
    real = lm.forward_hidden
    try:
        lm.forward_hidden = lambda *a, **k: real(*a, **{**k, "remat": False})
        _, without = ts.loss_and_grads(api, params, tokens)
    finally:
        lm.forward_hidden = real
    assert all(torch.equal(a, b) for a, b in zip(opt.tree_leaves(with_remat), opt.tree_leaves(without)))
