"""The port's sharding solver, logical axes, meshes and launch defaults
against the JAX package's, on the CPU.

JAX's ``spec_for_dims`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, so an object carrying those two serves as its mesh
(no fake devices); the port's solver reads a size map. Specs compare as
tuples of mesh axis names. The port unstacks each segment's ``layers`` dim,
which no rule shards: a JAX segment leaf's spec is ``(None, *port spec)``,
or ``()`` for both. ``cache_shardings`` needs a JAX mesh of devices, a tiled
one as ``tests/test_production_shardings.py`` builds.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test process: the suite runs a worker a core
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import defaults as jdefaults  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import RunConfig as JRun  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import defaults, mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _jax_mesh(sizes):
    """What JAX's solver reads of a mesh, and nothing else."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values()), dtype=np.int8))


def _is_names(x):
    return isinstance(x, tuple) and all(isinstance(s, str) for s in x)


def _pairs(port_axes, port_shapes, jax_axes, jax_shapes, stacked=False, path=""):
    """(path, port dims, port shape, JAX dims, JAX shape, stacked) for each
    leaf, the port's tree walked beside JAX's through convert.py's mapping
    (segment s, repeat r of the port = repeat r of JAX's stacked leaf)."""
    if _is_names(port_axes):
        yield path, port_axes, tuple(port_shapes.shape), jax_axes, tuple(jax_shapes.shape), stacked
        return
    if isinstance(port_axes, dict):
        assert set(port_axes) == set(jax_axes), path
        for k in port_axes:
            if path == "" and k == "segments":
                for si, (seg_t, seg_ts) in enumerate(zip(port_axes[k], port_shapes[k])):
                    for r, (blk, blk_s) in enumerate(zip(seg_t, seg_ts)):
                        yield from _pairs(blk, blk_s, jax_axes[k][si], jax_shapes[k][si], True,
                                          f"segments/{si}/{r}")
            else:
                yield from _pairs(port_axes[k], port_shapes[k], jax_axes[k], jax_shapes[k],
                                  stacked, f"{path}/{k}")
        return
    raise AssertionError(f"{path}: unexpected node {type(port_axes).__name__}")


@functools.lru_cache(maxsize=None)
def _trees(arch):
    jspecs, jaxes = jlm.abstract_params(j_get_config(arch))
    cfg = get_config(arch)
    return list(_pairs(lm.param_axes(cfg), lm.abstract_params(cfg), jaxes, jspecs))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_axes_equal_jax_leaf_for_leaf(arch):
    pairs = _trees(arch)
    assert len(pairs) == len(_flat_tensors(lm.abstract_params(get_config(arch))))
    for path, dims, shape, jdims, jshape, stacked in pairs:
        if stacked:
            assert jdims[0] == "layers" and jdims[1:] == dims, path
            assert jshape[1:] == shape, path
        else:
            assert jdims == dims and jshape == shape, path
        assert len(dims) == len(shape), path


def _flat_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat_tensors(v)]
    return [t for v in tree for t in _flat_tensors(v)]


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_solver_equals_jax_on_every_leaf_at_full_size(arch, mesh_name):
    sizes = MESHES[mesh_name]
    jm = _jax_mesh(sizes)
    pairs = _trees(arch)
    for head_aware in (False, True):
        for fsdp in (False, True):
            lay = dataclasses.replace(defaults.default_layout(get_config(arch)),
                                      head_aware=head_aware, fsdp=fsdp)
            jlay = dataclasses.replace(jdefaults.default_layout(j_get_config(arch)),
                                       head_aware=head_aware, fsdp=fsdp)
            for path, dims, shape, jdims, jshape, stacked in pairs:
                t = shd.spec_for_dims(dims, shape, sizes, lay)
                j = tuple(jshd.spec_for_dims(jdims, jshape, jm, jlay))
                want = ((None,) + tuple(t) if t else ()) if stacked else tuple(t)
                assert j == want, (path, head_aware, fsdp, j, t)


def test_param_shardings_tree_and_replication():
    cfg = get_config("qwen2_0_5b")
    specs = shd.param_shardings(lm.param_axes(cfg), lm.abstract_params(cfg),
                                {"data": 2, "model": 1}, defaults.default_layout(cfg))
    leaves = shd.spec_leaves(specs)
    assert len(leaves) == len(_flat_tensors(lm.abstract_params(cfg)))
    assert all(shd.is_replicated(s, {"data": 2, "model": 1}) for s in leaves)
    on_tp = shd.spec_leaves(shd.param_shardings(lm.param_axes(cfg), lm.abstract_params(cfg),
                                                MESHES["16x16"], defaults.default_layout(cfg)))
    assert any(not shd.is_replicated(s, MESHES["16x16"]) for s in on_tp)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "jamba_1_5_large", "xlstm_1_3b",
                                  "gemma3_27b"])
@pytest.mark.parametrize("shape", [(4, 2), (16, 16)])
def test_cache_shardings_equal_jax_on_the_reduced_caches(arch, shape):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    devs = np.array(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    jm = jax.sharding.Mesh(devs.reshape(shape), ("data", "model"))
    sizes = dict(zip(("data", "model"), shape))
    for batch in (1, 8):
        jt = jshd.cache_shardings(jlm.cache_specs(jcfg, batch, 64), jm,
                                  jdefaults.default_layout(jcfg))
        tt = shd.cache_shardings(lm.init_cache(cfg, batch, 64, "cpu"), sizes,
                                 defaults.default_layout(cfg))
        jl = [tuple(s.spec) for s in jax.tree_util.tree_leaves(jt)]
        tl = [tuple(s) for s in jax.tree_util.tree_leaves(
            tt, is_leaf=lambda x: isinstance(x, shd.PartitionSpec))]
        assert jl == tl and len(tl) > 0, (batch, jl, tl)
        # a batch's specs: dim 0 over the data axes that divide it
        batch_tree = {"tokens": np.zeros((batch, 16), np.int32), "step": np.zeros(())}
        jd = jshd.data_specs(batch_tree, jm, jdefaults.default_layout(jcfg))
        td = shd.data_specs(batch_tree, sizes, defaults.default_layout(cfg))
        assert {k: tuple(v.spec) for k, v in jd.items()} == {k: tuple(v) for k, v in td.items()}


@given(dims=st.lists(st.sampled_from(["vocab", "ff", "heads", "kv_heads", "experts",
                                      "d_model", "other"]), min_size=1, max_size=3, unique=True),
       sizes=st.lists(st.sampled_from([1, 2, 3, 8, 16, 64, 256]), min_size=3, max_size=3),
       fsdp=st.booleans(), head_aware=st.booleans())
@settings(max_examples=60, deadline=None)
def test_spec_never_violates_divisibility_and_equals_jax(dims, sizes, fsdp, head_aware):
    """JAX's property test, on the port's solver, and the two solvers equal."""
    mesh_sizes = {"data": 4, "model": 2}
    counts = (("heads", 6), ("kv_heads", 2), ("experts", 4))
    shape = tuple(sizes[:len(dims)])
    spec = shd.spec_for_dims(dims, shape, mesh_sizes,
                             shd.Layout(fsdp=fsdp, counts=counts, head_aware=head_aware))
    used = []
    for i, part in enumerate(spec):
        if part is None:
            continue
        n = 1
        for a in (part if isinstance(part, tuple) else (part,)):
            n *= mesh_sizes[a]
            used.append(a)
        assert shape[i] % n == 0, (dims, shape, spec)
    assert len(used) == len(set(used)), spec
    jspec = jshd.spec_for_dims(dims, shape, _jax_mesh(mesh_sizes),
                               jshd.Layout(fsdp=fsdp, counts=counts, head_aware=head_aware))
    assert tuple(jspec) == tuple(spec)


def test_data_parallel_rules_equal_jax():
    lay, jlay = shd.Layout(data_axes=("data", "model")), jshd.Layout(data_axes=("data", "model"))
    for sizes in ({"data": 2, "model": 1}, {"data": 4, "model": 2},
                  {"pod": 2, "data": 16, "model": 16}):
        jm = _jax_mesh(sizes)
        for b in (1, 2, 3, 4, 8, 12, 64, 512):
            assert shd.data_parallel_degree(sizes, lay, b) == \
                jshd.data_parallel_degree(sizes, jlay, b)
            assert shd.local_shard_shape((b, 7), sizes, lay) == \
                jshd.local_shard_shape((b, 7), sizes, jlay)
            assert tuple(shd.batch_spec(sizes, lay, b)) == tuple(jshd.batch_spec(jm, jlay, b))
    shapes = [(64, 16), (16, 64), (48, 8)]
    for kw in ({}, {"batch_arg_indices": [0]}, {"batch_arg_dims": {0: 1, 1: 0}}):
        with shd.mesh_context(mesh.make_host_mesh(), lay, dp_degree=2, dp_approx=True):
            t = shd.localize_shapes(shapes, **kw)
            assert shd.current_dp_degree() == 2 and shd.current_dp_approx()
        with jshd.mesh_context(jmesh.make_host_mesh(), jlay, dp_degree=2):
            j = jshd.localize_shapes(shapes, **kw)
        assert t == j
    assert shd.localize_shapes(shapes) == tuple(shapes)     # no context: global
    assert shd.current_mesh_layout() is None
    x = torch.ones(3)
    assert shd.constrain(x, "data") is x and shd.constrain_heads(x, 2, 0) is x


def test_mesh_specs_and_the_host_mesh():
    for spec in ("2x4", "2x16x16", "16X16"):
        assert mesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)
    for bad in ("2", "2x2x2x2", "axb"):
        with pytest.raises(ValueError):
            mesh.parse_mesh_spec(bad)
    host = mesh.make_host_mesh()
    assert shd.mesh_axis_sizes(host) == {"data": 1, "model": 1} and host.size() == 1
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh_from_spec("2x1")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_production_mesh()


def _fields(run):
    return {f.name: getattr(run, f.name) for f in dataclasses.fields(run)}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launch_defaults_equal_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(defaults.default_layout(cfg)) == \
        dataclasses.asdict(jdefaults.default_layout(jcfg))
    assert defaults.TUNED == jdefaults.TUNED and defaults._BIG == jdefaults._BIG
    from repro.configs.base import SHAPES as JSHAPES

    for name in ("train_smoke", "train_4k", "prefill_32k", "decode_32k"):
        jshape = JSHAPES[name]
        shape = SHAPES.get(name) or ShapeSpec(jshape.name, jshape.seq_len, jshape.global_batch,
                                              jshape.kind)
        t, j = _fields(defaults.default_run(cfg, shape)), _fields(
            jdefaults.default_run(jcfg, jshape))
        assert {k: v for k, v in j.items() if k in t} == {k: t[k] for k in j if k in t}
        # mamba_chunk is inert in JAX; RunConfig.grad_compression is read by
        # JAX's launch/steps.py alone (both trainers read TrainerConfig's)
        assert set(j) - set(t) == {"mamba_chunk", "grad_compression"}
        assert defaults.tuned_overrides(cfg, shape) == jdefaults.tuned_overrides(jcfg, jshape)
    assert isinstance(defaults.default_run(cfg, SHAPES["train_2k"]), RunConfig)
    assert JRun().remat == "dots" and RunConfig().remat == "none"


class _Mesh:
    """A mesh of ``sizes`` seen from its rank 0, with no process group: the
    Trainer reads its sizes before anything collective."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.mesh = torch.zeros(tuple(sizes.values()))

    def size(self):
        return self.mesh.numel()

    def get_coordinate(self):
        return [0] * self.mesh.dim()


@pytest.mark.parametrize("arch,sizes", [("qwen2_0_5b", {"data": 1, "model": 2}),
                                        ("qwen2_0_5b", {"data": 2, "model": 2}),
                                        ("mixtral_8x7b", {"data": 2, "model": 1}),
                                        ("gemma3_27b", {"data": 2, "model": 1})])
def test_trainer_refuses_a_spec_that_shards_a_parameter(arch, sizes):
    """FSDP (a big arch on data > 1) is a later slice: the Trainer says so
    instead of replicating in silence. A spec that cuts a parameter over
    the tensor axis (model > 1) is run since tensor parallelism was ported
    (tests/test_torch_tp*.py): the Trainer takes it, and here, with no
    process group behind the mesh, stops at its first collective instead."""
    cfg = get_config(arch).reduced()
    make = lambda: Trainer(cfg, RunConfig(), DataConfig(batch_size=4, seq_len=8), device="cpu",
                           mesh=_Mesh(sizes))
    if sizes["model"] > 1:
        with pytest.raises(Exception) as e:
            make()
        assert not isinstance(e.value, NotImplementedError), e.value
        return
    with pytest.raises(NotImplementedError, match="FSDP|later slice"):
        make()
