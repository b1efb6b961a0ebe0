"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``), on the CPU: the structural HBM-traffic model and the
FLOP count are the reference's, to the byte; ``collective_bytes`` parses
the same HLO text to the same sums; ``roofline_terms`` divides by the H100
SXM's rates (``core.hardware``), not the TPU's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from repro import configs as ref_configs
from repro.core import hardware as ref_hardware
from repro.roofline import analysis as ref_analysis
from repro.roofline import memory_model as ref_memory_model
from repro_torch import configs
from repro_torch.core import hardware
from repro_torch.models.registry import SHAPES
from repro_torch.roofline import analysis, memory_model


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_memory_model_equals_reference(arch):
    for smoke in (False, True):
        cfg, rcfg = configs.get_config(arch, smoke=smoke), ref_configs.get_config(arch, smoke=smoke)
        for name, shape in SHAPES.items():
            for fn in ("hbm_bytes", "_cache_bytes"):
                args = (shape["kind"], shape["batch"], shape["seq"]) if fn == "hbm_bytes" else (shape["batch"], shape["seq"])
                assert getattr(memory_model, fn)(cfg, *args) == getattr(ref_memory_model, fn)(rcfg, *args), (name, fn)
        for fn in ("train_bytes", "prefill_bytes"):
            assert getattr(memory_model, fn)(cfg, 16, 512) == getattr(ref_memory_model, fn)(rcfg, 16, 512)
        assert memory_model.decode_bytes(cfg, 4, 128) == ref_memory_model.decode_bytes(rcfg, 4, 128)


def test_model_flops_equal_reference():
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        n = cfg.param_count()
        for kind in ("train", "prefill", "decode"):
            assert analysis.model_flops_per_step(n, n // 3, 8192, kind) == \
                ref_analysis.model_flops_per_step(n, n // 3, 8192, kind)
    # smollm-135m's train step at 16 × 512 (chip_smoke.py phase 3j)
    n = configs.get_config("smollm-135m").param_count()
    assert analysis.model_flops_per_step(n, n, 8192, "train") == pytest.approx(6.61e12, rel=1e-3)


HLO = """
  all-reduce-start.1 = (f32[128,8]{1,0}, bf16[64]{0}) all-reduce-start(p0, p1), replica_groups={{0,1}}
  all-reduce-done.1 = (f32[128,8]{1,0}, bf16[64]{0}) all-reduce-done(all-reduce-start.1)
  ag = bf16[16,1024]{1,0} all-gather(x), dimensions={0}
  rs = f32[4,256]{1,0} reduce-scatter(y), dimensions={0}, to_apply=add
  a2a = s8[8,8,8]{2,1,0} all-to-all(z), dimensions={0}
  cp-start = (u32[3]{0}, u32[3]{0}) collective-permute-start(w), source_target_pairs={{0,1}}
  cp-done = u32[3]{0} collective-permute-done(cp-start)
  add.7 = f32[128,8]{1,0} add(a, b)
  fusion.1 = f32[2]{0} fusion(all-gather), kind=kLoop
"""


def _lowered_hlo() -> str:
    """HLO of a one-device shard_map with four kinds of collective."""
    from jax.experimental.shard_map import shard_map

    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))

    def f(a, b):
        return (jax.lax.psum(a, "x"), jax.lax.all_gather(b, "x"), jax.lax.ppermute(a, "x", [(0, 0)]),
                jax.lax.psum_scatter(a, "x", tiled=True))

    fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(), P()), out_specs=(P(),) * 4, check_rep=False))
    return fn.lower(jnp.ones((8, 4), jnp.float32), jnp.ones((16,), jnp.bfloat16)).as_text(dialect="hlo")


@pytest.mark.parametrize("source", ["fixed", "lowered"])
def test_collective_bytes_equal_reference(source):
    text = HLO if source == "fixed" else _lowered_hlo()
    got, want = analysis.collective_bytes(text), ref_analysis.collective_bytes(text)
    assert got == want
    if source == "fixed":
        assert got["bytes"] == {"all-gather": 32768, "all-reduce": 4224, "reduce-scatter": 4096, "all-to-all": 512,
                                "collective-permute": 24}
        assert got["count"]["all-reduce"] == 1 and got["total_bytes"] == 41624
    else:
        assert {k for k, c in got["count"].items() if c} == {"all-reduce", "all-gather", "reduce-scatter",
                                                             "collective-permute"}


def test_roofline_terms_use_the_h100():
    assert hardware.H100_PEAK_FLOPS_BF16 == 989e12 and hardware.H100_HBM_BPS == 3.35e12
    assert hardware.H100_NVLINK_BPS * 2 * 18 == 900e9  # NVLink 4: 18 links, 900 GB/s both ways
    r = analysis.roofline_terms(6.61e12, 6.89e9, 5e8, 1)
    assert r.compute_s == 6.61e12 / 989e12 and r.memory_s == 6.89e9 / 3.35e12 and r.collective_s == 5e8 / 25e9
    assert r.dominant == "collective" and r.to_dict()["chips"] == 1
    four = analysis.roofline_terms(6.61e12, 6.89e9, 0.0, 4)
    assert four.compute_s == r.compute_s / 4 and four.dominant == "compute"
    ref = ref_analysis.roofline_terms(6.61e12, 6.89e9, 0.0, 4)
    assert ref.compute_s == 6.61e12 / (4 * ref_hardware.TPU_PEAK_FLOPS_BF16) != four.compute_s
    assert set(r.to_dict()) == set(ref.to_dict())
