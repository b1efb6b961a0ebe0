"""The port's sharding rules (``repro_torch.distributed.sharding``) and spec
builders against the reference's ``PartitionSpec``s, on the CPU.

Every spec tree of the ten archs at their full configs — ``param_specs``,
``cache_specs``, ``input_specs`` and ``optimizer.state_specs`` — under both
policies, on the reference's 16×16 and 2×16×16 meshes (``AbstractMesh``
for the reference, a {name: size} shape for the port: the rules need no
process group), raw and sanitised against each package's own parameter
shapes.  Equality is exact after ``tuple()``.  The port keeps one spec dict
per layer where the reference stacks the layers, so its per-layer specs,
all equal, map to the reference's with a leading None.

``placements`` against the index arithmetic of JAX's major-to-minor split:
a (4, 8) arange on a fake 2×2 mesh, one rank at a time, and the rules'
errors.  The spec trees of the SMOKE configs follow their params' structure.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sh
from repro.models import registry as ref_registry
from repro.training import optimizer as ref_opt
from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.models import registry
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")), "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
POLICIES = ("tp", "dp")


def _port_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _ref_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _ref_structs(arch):
    api = ref_registry.build(ref_configs.get_config(arch))
    return api, jax.eval_shape(api.init_params, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    """The port's parameter tree as fake tensors (shapes, no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    api = registry.build(configs.get_config(arch))
    with FakeTensorMode():
        return api, api.init_tree(0)


def _stacked(port_tree):
    """The port's spec tree in the reference's layout: each per-layer list
    (all entries equal) becomes one spec with a leading None."""
    if isinstance(port_tree, list):
        first = port_tree[0]
        assert all(t == first for t in port_tree)
        return _stacked_layer(first)
    if isinstance(port_tree, dict):
        return {k: _stacked(v) for k, v in port_tree.items()}
    return tuple(port_tree)


def _stacked_layer(tree):
    if isinstance(tree, dict):
        return {k: _stacked_layer(v) for k, v in tree.items()}
    return (None, *tree)


def _plain(ref_tree):
    """The reference's spec tree with every PartitionSpec as a tuple."""
    if isinstance(ref_tree, dict):
        return {k: _plain(v) for k, v in ref_tree.items()}
    return tuple(ref_tree)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_and_state_specs_equal_the_reference(arch, policy, mesh_name):
    ref_api, structs = _ref_structs(arch)
    api, shapes = _port_shapes(arch)
    rmesh, pmesh = _ref_mesh(mesh_name), _port_mesh(mesh_name)
    with ref_sh.policy(policy), sh.policy(policy):
        ref = ref_api.param_specs(rmesh)
        got = api.param_specs(pmesh)
        assert _stacked(got) == _plain(ref)
        ref_s = ref_sh.sanitize_tree(ref, structs, rmesh)
        got_s = sh.sanitize_tree(got, shapes, pmesh)
        assert _stacked(got_s) == _plain(ref_s)
        ref_state = ref_opt.state_specs(ref_s)
        got_state = opt.state_specs(got_s)
        assert set(got_state) == set(ref_state) == {"m", "v", "step"}
        assert tuple(got_state["step"]) == tuple(ref_state["step"]) == ()
        for k in ("m", "v"):
            assert _stacked(got_state[k]) == _plain(ref_state[k])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_and_input_specs_equal_the_reference(arch, policy, mesh_name):
    ref_api, _ = _ref_structs(arch)
    api = registry.build(configs.get_config(arch))
    rmesh, pmesh = _ref_mesh(mesh_name), _port_mesh(mesh_name)
    dtypes = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}
    with ref_sh.policy(policy), sh.policy(policy):
        assert _plain(api.cache_specs(pmesh)) == _plain(ref_api.cache_specs(rmesh))
        for shape in registry.SHAPES:
            ref = ref_api.input_specs(shape, rmesh)
            got = api.input_specs(shape, pmesh)
            assert list(got) == list(ref)
            for k, (struct, spec) in ref.items():
                (g_shape, g_dtype), g_spec = got[k]
                assert g_shape == struct.shape and g_dtype == dtypes[struct.dtype.type]
                assert tuple(g_spec) == tuple(spec)
                assert tuple(sh.sanitize_spec(g_spec, g_shape, pmesh)) == tuple(
                    ref_sh.sanitize_spec(spec, struct.shape, rmesh))
            # the cache's sanitised specs, against each package's cache shapes
            info = registry.SHAPES[shape]
            ref_c = jax.eval_shape(lambda: ref_api.init_cache(info["batch"], info["seq"]))
            from torch._subclasses.fake_tensor import FakeTensorMode

            with FakeTensorMode():
                got_c = api.init_cache(info["batch"], info["seq"], device="cpu")
            assert _plain(sh.sanitize_tree(api.cache_specs(pmesh), got_c, pmesh)) == _plain(
                ref_sh.sanitize_tree(ref_api.cache_specs(rmesh), ref_c, rmesh))


@pytest.mark.parametrize("policy", POLICIES)
def test_rules_equal_the_reference_at_small_meshes(policy):
    """weight_spec, batch_spec, dp_axes and divisible on odd and even sizes."""
    for shape, axes in (((2, 2), ("data", "model")), ((2, 1, 1), ("pod", "data", "model")), ((4, 3), ("data", "model"))):
        rmesh = AbstractMesh(shape, axes)
        pmesh = types.SimpleNamespace(shape=dict(zip(axes, shape)))
        with ref_sh.policy(policy), sh.policy(policy):
            assert sh.dp_axes(pmesh) == ref_sh.dp_axes(rmesh)
            for dims in ((6, 8), (25, 12), (32001, 64), (9, 9), (4,)):
                for tp in (None, *range(len(dims))):
                    for fs in (None, *range(len(dims))):
                        assert tuple(sh.weight_spec(pmesh, dims, tp, fs)) == tuple(
                            ref_sh.weight_spec(rmesh, dims, tp, fs))
            for nd, seq in ((3, None), (3, 1), (2, 1)):
                assert tuple(sh.batch_spec(pmesh, nd, seq, True)) == tuple(ref_sh.batch_spec(rmesh, nd, seq, True))
                assert tuple(sh.batch_spec(pmesh, nd)) == tuple(ref_sh.batch_spec(rmesh, nd))


def test_policy_and_spec_type():
    assert sh.current_policy() == "tp"
    with sh.policy("dp"):
        assert sh.current_policy() == "dp"
    assert sh.current_policy() == "tp"
    with pytest.raises(ValueError):
        with sh.policy("fsdp"):
            pass
    assert sh.Spec("data", None) == ("data", None) and tuple(sh.Spec()) == ()
    assert repr(sh.Spec(("pod", "data"))) == "Spec(('pod', 'data'),)"


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_spec_trees_follow_the_params(arch):
    """At SMOKE size: every parameter and cache tensor has a spec, and the
    spec trees have the params' structure (the per-layer lists included)."""
    cfg = configs.get_config(arch, smoke=True)
    api = registry.build(cfg)
    mesh = _port_mesh("16x16")
    params = api.init_params(0, device="cpu")
    specs = api.param_specs(mesh)
    n = len(opt.tree_leaves(params))
    seen = []
    sh.spec_map(lambda s, p: seen.append((len(s) <= p.ndim, p.shape)), specs,
                opt.tree_map(lambda x: x, params))
    assert len(seen) == n and all(ok for ok, _ in seen)
    cache = api.init_cache(2, 16, device="cpu")
    assert set(api.cache_specs(mesh)) == set(cache)


@pytest.fixture
def fake_rank():
    """Start a fake process group of 4 ranks as the given rank; ended after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(rank):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


SPLITS = [sh.Spec(("data", "model"), None), sh.Spec(None, ("data", "model")), sh.Spec("data", "model"),
          sh.Spec("model", "data"), sh.Spec("model", None), sh.Spec(None, "data"), sh.Spec()]


def _jax_block(spec, shape, coords, sizes):
    """Rank (d, m)'s block of a (4, 8) array under ``spec``, by JAX's rule: a
    dim over axes (a1, a2, ...) is split in prod(sizes) blocks, block index
    major-to-minor in the entry's order (data_index · size(model) +
    model_index for ("data", "model"))."""
    idx = []
    for dim, part in zip(shape, list(spec) + [None] * (len(shape) - len(spec))):
        axes = () if part is None else (part if isinstance(part, tuple) else (part,))
        n, b = 1, 0
        for a in axes:
            b = b * sizes[a] + coords[a]
            n *= sizes[a]
        step = dim // n
        idx.append(slice(b * step, (b + 1) * step))
    return tuple(idx)


@pytest.mark.parametrize("spec", SPLITS, ids=str)
def test_placements_split_as_jax_does(spec, fake_rank):
    from repro_torch.launch.mesh import make_mesh

    x = torch.arange(32).reshape(4, 8)
    for rank in range(4):
        fake_rank(rank)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        coords = {"data": rank // 2, "model": rank % 2}
        local = sh.distribute(x, mesh, spec).to_local()
        want = x.numpy()[_jax_block(spec, x.shape, coords, {"data": 2, "model": 2})]
        assert np.array_equal(local.numpy(), want), (rank, spec)


def test_placements_rules(fake_rank):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_mesh

    fake_rank(0)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    assert sh.placements(sh.Spec(("data", "model")), mesh) == (Shard(0), Shard(0))
    assert sh.placements(sh.Spec(None, "data"), mesh) == (Shard(1), Replicate())
    assert sh.placements(sh.Spec(("pod", "data")), mesh) == (Shard(0), Replicate())  # absent axes drop
    assert sh.named(mesh, sh.Spec("model")) == (mesh, (Replicate(), Shard(0)))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sh.placements(sh.Spec(("model", "data")), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        sh.placements(sh.Spec("data", "data"), mesh)
    tree = sh.tree_shardings(mesh, {"a": sh.Spec("data"), "b": [sh.Spec(), sh.Spec(None, "model")]})
    assert tree["b"][1].placements == (Replicate(), Shard(1))
    # constrain: a redistribute on a mesh of 4, a no-op on a mesh of one
    x = sh.distribute(torch.ones(4, 4), mesh, sh.Spec("data"))
    assert sh.constrain(x, mesh, sh.Spec(None, "model")).placements == (Replicate(), Shard(1))
    assert sh.replicate(x).placements == (Replicate(), Replicate())


def test_make_mesh_needs_a_group_unless_asked_for_a_fake_one(fake_rank):
    """No running group raises (a job that forgot ``init_process_group`` gets
    no mesh whose collectives move nothing); ``fake=True`` starts one; the
    running group serves without it."""
    from repro_torch.core import executor as E
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group runs"):
        make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="no process group runs"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="no process group runs"):
        E.affiliation_mesh(2, "cpu")
    mesh = make_production_mesh(multi_pod=True, device_type="cpu", fake=True)
    assert dist.get_backend() == "fake" and mesh.size() == 512
    assert E.affiliation_mesh(8, "cpu", fake=True).size() == 8  # the fake group restarted at 8 ranks
    fake_rank(3)
    assert list(make_mesh((2, 2), ("data", "model"), "cpu").get_coordinate()) == [1, 1]


def test_one_device_mesh_constrain_is_a_no_op(fake_rank):
    from repro_torch.launch.mesh import single_device_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = single_device_mesh("cpu")
    assert dist.get_backend() == "gloo" and mesh.size() == 1 and mesh.mesh_dim_names == ("data", "model")
    x = sh.distribute(torch.arange(6.0).reshape(2, 3), mesh, sh.Spec("data", "model"))
    assert sh.constrain(x, mesh, sh.Spec()) is x
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        single_device_mesh("cuda")


def test_restore_places_shards_by_the_given_placements(fake_rank, tmp_path):
    """Elastic restore: a saved global array comes back as rank r's shard of
    the named placements on the mesh, rank by rank."""
    from repro_torch.checkpoint import manager
    from repro_torch.launch.mesh import make_mesh

    w = np.arange(32, dtype=np.float32).reshape(4, 8)
    manager.save(str(tmp_path), 1, {"w": w, "b": np.zeros(2, np.float32)})
    for rank in range(4):
        fake_rank(rank)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        spec = sh.Spec("data", "model")
        _, got = manager.restore(str(tmp_path), shardings={"w": sh.named(mesh, spec)})
        want = w[_jax_block(spec, w.shape, {"data": rank // 2, "model": rank % 2}, {"data": 2, "model": 2})]
        assert np.array_equal(got["w"].to_local().numpy(), want)
        assert isinstance(got["b"], np.ndarray)
