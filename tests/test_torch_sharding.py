"""The port's sharding rules (`repro_torch.launch.sharding`) and mesh
(`distributed.context`, `launch.mesh`) against the JAX package's, on the
CPU, symbolically: shape-only (16, 16) and (2, 16, 16) meshes, no
devices (as `tests/test_sharding.py` does with its `FakeMesh`).

For every arch of the registry the port's spec of every parameter (its
per-layer names: JAX's spec of the stacked leaf less the layer axis),
of every ZeRO-1 moment, of every cell's batch and of every cache equals
JAX's `ShardingRules`. Where JAX's ZeRO-1 cuts a stacked layer axis the
port cuts the layer's own first free dim (the module docstring), and
that is what is checked there. Then the blocks of `local_slice` and
`assemble`, `make_mesh`'s refusal of a world of the wrong size, and the
context's accessors."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, cells
from repro.configs import get_arch as jget_arch
from repro.distributed import context as jcontext
from repro.launch.sharding import ShardingRules as JRules
from repro.launch.specs import batch_shapes, cache_shapes, params_shapes
from repro.models.lm import _attn_layout
from repro_torch.configs import get_arch
from repro_torch.distributed import context as tcontext
from repro_torch.distributed.context import Mesh, mesh_context
from repro_torch.launch.mesh import (make_local_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.checkpoint.store import SEGMENTS
from repro_torch.launch.sharding import ShardingRules, assemble, local_slice


class FakeMesh:
    """Shape-only stand-in for JAX's production mesh."""

    def __init__(self, multi):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


def port_leaves(tree):
    """JAX's parameter tree as the port's per-layer leaves: (port name,
    per-layer shape, JAX's flat path, stacked)."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] in SEGMENTS:
            L = leaf.shape[0]
            for i in sorted({0, L - 1}):
                out.append((".".join([keys[0], str(i)] + keys[1:]),
                            leaf.shape[1:], path, True))
        else:
            out.append((".".join(keys), leaf.shape, path, False))
    return out


def spec_at(specs, path):
    node = specs
    for p in path:
        node = node[p.key]
    return tuple(node)


def jax_pair(arch, multi):
    cfg = jget_arch(arch)
    mesh = FakeMesh(multi)
    layout = _attn_layout(cfg, 16)
    return cfg, mesh, JRules(cfg, mesh, layout), layout


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch, multi):
    jcfg, jmesh, jrules, layout = jax_pair(arch, multi)
    mesh = Mesh(tuple(jmesh.shape.values()), jmesh.axis_names)
    rules = ShardingRules(get_arch(arch), mesh, layout)
    prev = getattr(jcontext._state, "mesh", None)
    jcontext._state.mesh = jmesh
    try:
        with mesh_context(mesh):
            ps = params_shapes(jcfg)
            jspecs = jrules.params_specs(ps)
            jmom = jrules.opt_specs(ps, jspecs)["mu"]
            n_layer_cut = 0
            for name, shape, path, stacked in port_leaves(ps):
                want = spec_at(jspecs, path)
                got = rules.param_spec(name, shape)
                assert got == (want[1:] if stacked else want), name
                wmom = spec_at(jmom, path)
                gmom = rules.zero1_spec(got, shape)
                if stacked and wmom[0] == "data":
                    # JAX cut the layer axis: the port cuts the layer
                    n_layer_cut += 1
                    assert wmom[1:] == got, name
                    free = [d for d, a in zip(shape, got)
                            if a is None and d % mesh.shape["data"] == 0]
                    assert ("data" in gmom) == bool(free), name
                else:
                    assert gmom == (wmom[1:] if stacked else wmom), name
            if arch in ("musicgen_medium", "mamba2_780m",
                        "llava_next_mistral_7b"):
                assert n_layer_cut > 0
            for shape in cells(arch):
                bs = batch_shapes(jcfg, shape)
                jb = jrules.batch_specs(bs)
                tb = rules.batch_specs({k: v.shape for k, v in bs.items()})
                assert {k: tuple(v) for k, v in jb.items()} == tb, shape.name
                if shape.kind == "train":
                    continue
                cs = cache_shapes(jcfg, shape)
                jc = jrules.cache_specs(cs)
                tc = rules.cache_specs(jax.tree.map(lambda a: a.shape, cs))
                flat_j = jax.tree_util.tree_flatten_with_path(
                    jc, is_leaf=lambda x: isinstance(x, P))[0]
                for path, sp in flat_j:
                    assert spec_at(tc, path) == tuple(sp), (shape.name,
                                                            path)
    finally:
        jcontext._state.mesh = prev


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_held_specs_are_jax_params_specs_on_the_model_axis(arch, multi):
    """The specs the port holds (`held_spec`, `held_moment_spec`) are
    JAX's `params_specs` and `opt_specs` for every family (ROADMAP items
    10.3b and 10.3c: MLA's heads, the SSM's d_in, the RG-LRU's width and
    gate blocks too; FSDP configs' 'data' dims included)."""
    jcfg, jmesh, jrules, layout = jax_pair(arch, multi)
    cfg = get_arch(arch)
    mesh = Mesh(tuple(jmesh.shape.values()), jmesh.axis_names)
    rules = ShardingRules(cfg, mesh, layout)
    prev = getattr(jcontext._state, "mesh", None)
    jcontext._state.mesh = jmesh
    try:
        with mesh_context(mesh):
            ps = params_shapes(jcfg)
            jspecs = jrules.params_specs(ps)
            for name, shape, path, stacked in port_leaves(ps):
                want = spec_at(jspecs, path)
                want = want[1:] if stacked else want
                assert rules.held_spec(name, shape) == want, name
                assert rules.held_moment_spec(name, shape) == \
                    rules.zero1_spec(want, shape), name
    finally:
        jcontext._state.mesh = prev


@pytest.mark.parametrize("spec", [("data", None), (None, "model"),
                                  ("model", "data"), (("pod", "data"), None),
                                  (None, None)])
def test_local_slice_blocks_tile_the_leaf(spec):
    """On a (pod 2, data 2, model 3) mesh every rank's block has the
    leaf's shape divided by its axes' sizes, a dim cut over several axes
    numbers its blocks row-major over them (JAX's order), replicas hold
    the same block, and `assemble` puts the blocks back (numpy and
    torch)."""
    shape = (12, 12)
    axes, mshape = ("pod", "data", "model"), (2, 2, 3)
    mesh = Mesh(mshape, axes)
    x = np.arange(144).reshape(shape)
    blocks = []
    for r in range(mesh.size):
        c = dict(zip(axes, (int(v) for v in np.unravel_index(r, mshape))))
        idx = local_slice(spec, shape, mesh, c)
        assert x[idx].shape == tuple(
            d // (1 if a is None else mesh.axis_size(a))
            for d, a in zip(shape, spec))
        if spec[0] == ("pod", "data"):
            k = 2 * c["pod"] + c["data"]
            assert idx[0] == slice(3 * k, 3 * k + 3)
        blocks.append(x[idx])
    assert np.array_equal(assemble(blocks, spec, shape, mesh), x)
    t = torch.from_numpy(x)
    assert torch.equal(assemble([torch.from_numpy(b) for b in blocks], spec,
                                shape, mesh), t)
    with pytest.raises(ValueError, match="does not divide"):
        local_slice(("model", None), (8, 12), mesh)


def test_meshes_over_the_live_world():
    """One process is a world of one: the local mesh is (1, 1); the
    production meshes need 256 and 512 ranks and say so, as JAX's
    `make_mesh` refuses too few devices."""
    m = make_local_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.rank == 0
    with pytest.raises(ValueError, match=r"\(16, 16\) mesh needs 256"):
        make_production_mesh()
    with pytest.raises(ValueError, match=r"\(2, 16, 16\) mesh needs 512"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((1, 2), ("data", "model"))


def test_context_accessors_match_jax():
    assert tcontext.get_mesh().shape == {"data": 1, "model": 1}
    for shape, names, baxes, dp, tp in (
            ((16, 16), ("data", "model"), ("data",), 16, 16),
            ((2, 16, 16), ("pod", "data", "model"), ("pod", "data"), 32, 16)):
        with mesh_context(Mesh(shape, names, rank=5)) as m:
            assert tcontext.batch_axes() == baxes
            assert tcontext.dp_size() == dp and tcontext.tp_size() == tp
            assert tcontext.tp_axis() == "model"
            x = torch.ones(3)
            assert tcontext.constrain(x, "batch", None) is x
            assert m.coords["model"] == 5 and m.index("model") == 5
            with pytest.raises(RuntimeError, match="shape-only"):
                m.psum(x, "data")
    assert tcontext.get_mesh().shape == {"data": 1, "model": 1}
    # the batch axes' groups are row-major over (pod, data)
    m = Mesh((2, 2, 2), ("pod", "data", "model"))
    assert m.partition(("pod", "data")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert m.partition("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
