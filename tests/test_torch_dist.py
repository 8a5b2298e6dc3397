"""The port's partition rules and per-device bytes (``repro_torch.dist``)
against the reference's (``repro.dist``), on abstract meshes: no device
is used on either side.  The reference's trees come from
``jax.eval_shape`` of its init and caches at every config's full size;
the port's are its modules and caches on the meta device.

Specs are compared exactly: each port parameter's spec is the
reference's spec of its ``convert._jax_path`` leaf with the stacking
entry dropped.  Bytes are compared exactly: a device's bytes of the
port's parameters, AdamW moments (the reference's int32 step counter is
a host integer in the port), batch and caches equal the sum of
``NamedSharding(mesh, spec).shard_shape`` over the reference's leaves.
The one named exception: a leaf whose reference spec shards its
stacking dim (the catch-all rule's FSDP search starts there), which the
port's per-layer tensors hold whole on each device."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro import optim as joptim
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_model_config as jax_config
from repro.dist import constraints as jconstraints
from repro.dist import sharding as jsharding
from repro.models import model as jmodel_mod
from repro_torch.configs import ARCH_IDS, SHAPES, get_model_config
from repro_torch.dist import constraints, sharding
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import model as model_mod
from repro_torch.models.convert import _jax_path

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")), ((2, 32, 8), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((1, 1), ("data", "model"))]
VARIANTS = [dict(fsdp=True, fsdp_pods=False), dict(fsdp=False, fsdp_pods=False),
            dict(fsdp=True, fsdp_pods=True)]
BLOCK = 16


def meshes():
    return [(AbstractMesh(sizes, names), Mesh(names, sizes)) for sizes, names in MESHES]


def _key(p):
    return str(getattr(p, "key", getattr(p, "idx", p)))


def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key(p) for p in path): leaf for path, leaf in leaves}


def ref_bytes(mesh, specs, tree) -> int:
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    total = 0
    for spec, leaf in zip(spec_leaves, jax.tree.leaves(tree)):
        shape = NamedSharding(mesh, spec).shard_shape(tuple(leaf.shape))
        total += int(np.prod(shape)) * jnp.dtype(leaf.dtype).itemsize
    return total


_CACHE = {}


def pair(arch):
    """(reference model, its params' shapes, port model on meta)."""
    if arch not in _CACHE:
        jm = jmodel_mod.build_model(jax_config(arch), remat=False)
        params = jmodel_mod.param_specs(jm, jm.cfg, jnp.bfloat16)
        _CACHE[arch] = (jm, params, model_mod.param_specs(get_model_config(arch)))
    return _CACHE[arch]


def test_the_port_covers_the_reference_registry():
    assert ARCH_IDS == JAX_ARCH_IDS and set(SHAPES) == set(JAX_SHAPES)
    assert make_production_mesh().size == 256 and make_production_mesh(multi_pod=True).size == 512
    assert make_production_mesh().shape == {"data": 32, "model": 8}
    assert make_host_mesh(device="cpu") == Mesh(("data", "model"), (1, 1))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch):
    """Every port parameter, on every mesh and FSDP variant: the
    reference's spec of its leaf, stacking entry dropped; the parameter
    shapes are the leaf's without the stacking dim."""
    jm, params, model = pair(arch)
    leaves = flat(params)
    for jmesh, mesh in meshes():
        for kw in VARIANTS:
            ref = flat(jsharding.make_param_specs(jm.cfg, jmesh, params, **kw))
            got = sharding.make_param_specs(model.cfg, mesh, model, **kw)
            assert len(got) == sum(1 for _ in model.parameters())
            for name, p in model.named_parameters():
                path, unit = _jax_path(model, name)
                want = tuple(ref[path])
                leaf_shape = tuple(leaves[path].shape)
                if unit is not None:
                    want, leaf_shape = want[1:], leaf_shape[1:]
                assert tuple(p.shape) == leaf_shape, (name, path)
                assert got[name] == want, (arch, jmesh, kw, name, path)


def _stacked_leaf_bytes(jmesh, spec, leaf) -> int:
    """A device's bytes of a reference leaf under ``spec`` with its
    stacking entry replicated: what the port's per-layer tensors hold."""
    whole = P(None, *tuple(spec)[1:])
    shape = NamedSharding(jmesh, whole).shard_shape(tuple(leaf.shape))
    return int(np.prod(shape)) * jnp.dtype(leaf.dtype).itemsize


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_device_bytes_match_the_reference(arch):
    """A device's bytes of the parameters, m and v, each shape's batch
    and its cache (ring, and paged for decoder-only decode shapes) on
    every mesh, against the reference's shard shapes summed."""
    jm, params, model = pair(arch)
    cfg = model.cfg
    named = dict(model.named_parameters())
    f32 = {k: torch.empty(p.shape, dtype=torch.float32, device="meta") for k, p in named.items()}
    jopt = jax.eval_shape(joptim.init_state, params)
    for jmesh, mesh in meshes():
        for kw in VARIANTS:
            jspecs = jsharding.make_param_specs(jm.cfg, jmesh, params, **kw)
            specs = sharding.make_param_specs(cfg, mesh, model, **kw)
            stacked = sharding.stacked_fsdp(cfg, mesh, model, **kw)
            # the named exception: the reference's FSDP on a stacking dim,
            # each leaf's stack held whole by the port (in bf16, and m and v in f32)
            jflat, lflat = flat(jspecs), flat(params)
            paths = set()
            for name, spec in stacked.items():
                path, _ = _jax_path(model, name)
                assert tuple(jflat[path]) == spec and all(e is None for e in spec[1:]), name
                paths.add(path)
            fix = fix_opt = 0
            for path in paths:
                leaf = lflat[path]
                leaf32 = jax.ShapeDtypeStruct(leaf.shape, jnp.float32)
                fix += (_stacked_leaf_bytes(jmesh, jflat[path], leaf)
                        - ref_bytes(jmesh, jflat[path], leaf))
                fix_opt += 2 * (_stacked_leaf_bytes(jmesh, jflat[path], leaf32)
                                - ref_bytes(jmesh, jflat[path], leaf32))
            want = ref_bytes(jmesh, jspecs, params) + fix
            assert sharding.device_bytes(specs, named, mesh) == want, (arch, jmesh, kw)
            jopt_specs = jsharding.make_opt_specs(jspecs)
            want_opt = (ref_bytes(jmesh, jopt_specs["m"], jopt["m"])
                        + ref_bytes(jmesh, jopt_specs["v"], jopt["v"]) + fix_opt)
            assert 2 * sharding.device_bytes(specs, f32, mesh) == want_opt, (arch, jmesh, kw)
        for shape in SHAPES.values():
            jshape = JAX_SHAPES[shape.name]
            if shape.kind == "decode":
                jbatch = jmodel_mod.decode_batch_specs(jm.cfg, jshape)
                batch = model_mod.decode_batch_specs(cfg, shape)
            elif shape.kind == "train":
                jbatch = jmodel_mod.train_batch_specs(jm.cfg, jshape)
                batch = model_mod.train_batch_specs(cfg, shape)
            else:
                jbatch = jmodel_mod.prefill_batch_specs(jm.cfg, jshape)
                batch = model_mod.prefill_batch_specs(cfg, shape)
            assert (sharding.device_bytes(sharding.make_train_batch_specs(mesh, batch), batch, mesh)
                    == ref_bytes(jmesh, jsharding.make_train_batch_specs(jmesh, jbatch), jbatch))
            if shape.kind != "decode":
                continue
            b, s = shape.global_batch, shape.seq_len
            jcache = jmodel_mod.cache_specs(jm, jm.cfg, b, s, jnp.bfloat16)
            cache = model_mod.cache_specs(model, cfg, b, s)
            assert (sharding.device_bytes(sharding.make_cache_specs(cfg, mesh, cache), cache, mesh)
                    == ref_bytes(jmesh, jsharding.make_cache_specs(jm.cfg, jmesh, jcache), jcache)), \
                (arch, shape.name, jmesh)
            if cfg.is_encdec:
                continue
            n_blocks = b * -(-s // BLOCK)
            jpaged, jtables = jmodel_mod.paged_cache_specs(jm, jm.cfg, b, s, BLOCK, n_blocks,
                                                           jnp.bfloat16)
            paged, tables = model_mod.paged_cache_specs(model, cfg, b, s, BLOCK, n_blocks)
            assert tuple(tables.shape) == tuple(jtables.shape)
            assert (sharding.device_bytes(sharding.make_cache_specs(cfg, mesh, paged), paged, mesh)
                    == ref_bytes(jmesh, jsharding.make_cache_specs(jm.cfg, jmesh, jpaged), jpaged)), \
                (arch, shape.name, jmesh, "paged")


def test_stacked_fsdp_is_the_catch_all_rule_only():
    """The leaves whose reference spec shards the stacking dim: only
    unnamed recurrent-block leaves (conv kernels, gate vectors), only
    where the data axes divide the unit count."""
    seen = set()
    for arch in ARCH_IDS:
        jm, params, model = pair(arch)
        for jmesh, mesh in meshes():
            for kw in VARIANTS:
                for name in sharding.stacked_fsdp(model.cfg, mesh, model, **kw):
                    path, unit = _jax_path(model, name)
                    assert unit is not None and path.startswith("units/")
                    assert model.cfg.family in ("hybrid", "ssm"), (arch, name)
                    seen.add((arch, path.split("/", 2)[2]))
    assert seen, "no leaf takes the catch-all rule on a stacking dim"


TABLE = [(64, ()), (256, ()), (3, ()), (48, ()), (512, ()), (1, ()), (7, ())]
SPECS = [("dp", "model"), ("model", None), (("pod", "data"), None), ("dp", None, "model"),
         (None, ("data", "model")), ("pod",), ("expert", "model")]


def test_axis_arithmetic_matches_the_reference():
    for jmesh, mesh in meshes():
        assert constraints.axis_sizes(mesh) == jconstraints.axis_sizes(jmesh)
        for pods in (True, False):
            assert constraints.data_axes(mesh, pods=pods) == jconstraints.data_axes(jmesh, pods=pods)
            for dim, _ in TABLE:
                assert (constraints.divisible_data_axes(mesh, dim, pods=pods)
                        == jconstraints.divisible_data_axes(jmesh, dim, pods=pods))
        for dim, _ in TABLE:
            assert sharding.batch_spec(mesh, dim) == jsharding.batch_spec(jmesh, dim)
        for shape in [(64, 32), (48, 16, 8), (256, 7, 64), (2, 3), (512, 512)]:
            for axes in SPECS:
                assert (constraints.resolve_spec(mesh, shape, axes)
                        == tuple(jconstraints.resolve_spec(jmesh, shape, axes))), (shape, axes)


def test_shard_shape_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    jmesh, mesh = meshes()[1]
    for spec in [(("pod", "data"), "model"), (None, "model"), ("data", None), (None, None)]:
        shape = (64, 32)
        assert sharding.shard_shape(spec, shape, mesh) == \
            tuple(NamedSharding(jmesh, P(*spec)).shard_shape(shape))
    assert sharding.placements((("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert sharding.placements((None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]
