"""The port's LLM serving path (``repro_torch.serving.engine``,
``repro_torch.launch.serve``) against the reference's, on the CPU.

``smollm-135m`` runs at full width with ``chip_smoke.py``'s own seed,
weights and prompts: the smoke holds the card against the port's CPU path at
those inputs, and this file holds the CPU path against the reference.
Greedy tokens are compared only as far as the reference's top-2 logit
margin exceeds twice the logits' tolerance: two bfloat16 implementations
may break a closer call either way.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import registry as ref_registry
from repro.serving import engine as ref_engine
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference
from repro_torch.serving.engine import Engine, SamplerConfig

torch.set_num_threads(1)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
SMOKE_LOGITS = CS.SMOKE_TOL["logits"]
FULL_CACHE = dict(atol=0.15, rtol=0.02, corr=0.9995)  # smollm-135m's KV cache after 30 layers


def _pair(arch: str):
    rcfg, cfg = ref_configs.get_config(arch, smoke=True), configs.get_config(arch, smoke=True)
    rapi, api = ref_registry.build(rcfg), registry.build(cfg)
    rparams = rapi.init_params(jax.random.PRNGKey(0))
    return rcfg, rapi, rparams, cfg, api, params_from_reference(cfg, jax.tree.map(np.asarray, rparams), device="cpu")


def test_greedy_is_deterministic_and_sampling_follows_its_seed():
    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    eng = Engine(api, api.init_params(0, device="cpu"), batch=2, max_seq=32, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8), dtype=np.int32)
    greedy = eng.generate(prompts, 12)
    assert greedy.shape == (2, 12) and greedy.dtype == np.int32
    assert np.array_equal(greedy, eng.generate(prompts, 12))
    hot = [eng.generate(prompts, 12, SamplerConfig(temperature=1.0, seed=s)) for s in (5, 5, 6)]
    assert np.array_equal(hot[0], hot[1]) and not np.array_equal(hot[0], hot[2])
    assert hot[0].min() >= 0 and hot[0].max() < cfg.vocab


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_greedy_tokens_match_the_reference_engine(arch):
    """Greedy tokens, 2 rows × 12, against the reference's at SMOKE size.

    The reference's top-2 margins come from its logits along its own tokens.
    Where a margin exceeds twice the logits' tolerance (``2 × atol``), the
    port's greedy choice given the reference's prefix is the reference's.
    The port's Engine gives the reference Engine's tokens up to its first
    close call, if any."""
    rcfg, rapi, rparams, cfg, api, params = _pair(arch)
    b, n, smax = 2, 12, 64
    inp = CS.smoke_inputs(cfg, b, 16 + cfg.n_patches + cfg.enc_seq)
    inp.pop("token")
    prompts = inp.pop("tokens")
    extra_j = {k: jnp.asarray(v) for k, v in inp.items()}
    want = np.asarray(ref_engine.Engine(rapi, rparams, b, smax).generate(prompts, n, **extra_j))
    got = Engine(api, params, b, smax, device="cpu").generate(prompts, n, **inp)
    # both models along the reference's tokens: prefill, then each token fed back
    logits, cache = jax.jit(lambda p, c, **kw: rapi.prefill(p, c, **kw))(
        rparams, rapi.init_cache(b, smax), tokens=jnp.asarray(prompts), **extra_j)
    tlogits, tcache = api.prefill(params, api.init_cache(b, smax, device="cpu"), tokens=torch.from_numpy(prompts),
                                  **{k: torch.from_numpy(v) for k, v in inp.items()})
    clear, same = [], []
    for i in range(n):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        clear.append(top2[:, 1] - top2[:, 0] > 2 * SMOKE_LOGITS["atol"])
        same.append(tlogits.argmax(-1).numpy() == want[:, i])
        logits, cache = jax.jit(rapi.decode_step)(rparams, jnp.asarray(want[:, i]), cache)
        tlogits, tcache = api.decode_step(params, torch.from_numpy(want[:, i]), tcache)
    clear, same = np.stack(clear, 1), np.stack(same, 1)
    assert same[clear].all()
    for row in range(b):
        diff = np.nonzero(got[row] != want[row])[0]
        assert diff.size == 0 or not clear[row, diff[0]], (row, diff[0])


def test_smollm_full_width_matches_the_reference_teacher_forced():
    """smollm-135m at full width, chip_smoke.py's weights and inputs: prefill
    and 8 teacher-forced decode steps, logits and the final KV cache."""
    rcfg, cfg = ref_configs.get_config(CS.LLM["arch"]), configs.get_config(CS.LLM["arch"])
    tree = CS.llm_reference_tree(cfg, CS.LLM["seed"])
    prompts, forced = CS.llm_inputs(cfg)
    got, cache = CS.teacher_forced(registry.build(cfg), params_from_reference(cfg, tree, device="cpu"),
                                   prompts, forced, CS.LLM["max_seq"], "cpu")
    rapi = ref_registry.build(rcfg)
    rparams = jax.tree.map(jnp.asarray, tree)
    logits, rcache = jax.jit(lambda p, c, t: rapi.prefill(p, c, tokens=t))(
        rparams, rapi.init_cache(CS.LLM["batch"], CS.LLM["max_seq"]), jnp.asarray(prompts))
    want = [logits]
    decode = jax.jit(rapi.decode_step)
    for i in range(forced.shape[1]):
        logits, rcache = decode(rparams, jnp.asarray(forced[:, i]), rcache)
        want.append(logits)
    assert len(got) == len(want) == 1 + CS.LLM["forced"]
    for w, g in zip(want, got):
        assert g.shape == (CS.LLM["batch"], cfg.vocab) and g.dtype == torch.float32
        ok = CS.compare(torch.from_numpy(np.array(w)), g, **CS.LLM_TOL)
        assert ok[2], ok  # measured: max |d| ≤ 0.057, corr ≥ 0.99977
    assert int(cache["t"]) == int(rcache["t"]) == CS.LLM["prompt_len"] + CS.LLM["forced"]
    for k in ("k", "v"):  # measured: max |d| ≤ 0.11 (30 layers' drift, at values near 0)
        ok = CS.compare(torch.from_numpy(np.asarray(rcache[k].astype(jnp.float32))), cache[k], **FULL_CACHE)
        assert ok[2], (k, ok)


def test_launcher_defaults_and_device(monkeypatch, capsys):
    out = serve.main(["--device", "cpu"])  # smollm-135m at SMOKE size, the reference's defaults
    assert out.shape == (4, 32) and out.dtype == np.int32
    assert "[serve] arch=smollm-smoke generated (4, 32) tokens on cpu" in capsys.readouterr().out
    assert np.array_equal(out, serve.main(["--device", "cpu"]))
    assert serve.main(["--device", "cpu", "--arch", "whisper-medium", "--tokens", "3"]).shape == (4, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        serve.main([])


def test_engine_defaults_to_cuda_and_checks_where_the_params_live(monkeypatch):
    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    with pytest.raises(ValueError, match="the parameters live on"):
        Engine(api, params, batch=1, max_seq=8, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        Engine(api, params, batch=1, max_seq=8)
