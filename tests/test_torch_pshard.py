"""The port's logical-axis sharding rules against the JAX package's, with
no processes: `spec_for` and `partition_specs` over every leaf of every
arch's `model_specs` (the full config and `smoke()`), `ShardingRules.
replace`, `parity_pspec`, `copy_stack_pspec`, `opt_spec_tree` and
`fold_copy_axis`'s shapes, on the abstract meshes (2, 2), (2, 1), (3, 1)
and (3, 1, 2) ("copy", "data", "model") -- jax's `AbstractMesh` on the
reference's side, the port's on its own.  The reference's
`PartitionSpec` entries are compared as a plain tuple.  Plus the DTensor
placements of a spec, `Scheme.shardings` for every scheme, and
`shard_slices`: the ranks' slices of a leaf cover it exactly as often as
the spec replicates it (after tests/test_sharding.py)."""
import itertools

import numpy as np
import pytest

import jax
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.launch.mesh import fold_copy_axis as j_fold
from repro.models import params as JP
from repro.models import transformer as JT
from repro.optim import sharding_rules as JR
from repro.pshard import DEFAULT_RULES as J_RULES
from repro.pshard import spec_for as j_spec_for
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.launch.mesh import fold_copy_axis
from repro_torch.models import params as P
from repro_torch.models import transformer as PT
from repro_torch.optim import sharding_rules as R
from repro_torch.pshard import (DEFAULT_RULES, AbstractMesh, constrain,
                                shard_slices, spec_axes, spec_for,
                                to_placements)

MESHES = [((2, 2), ("data", "model")), ((2, 1), ("data", "model")),
          ((3, 1), ("data", "model")),
          ((3, 1, 2), ("copy", "data", "model"))]
MESH_IDS = ["2x2", "2x1", "3x1", "3x1x2"]


def _meshes(sizes, names):
    return JAbstractMesh(sizes, names), AbstractMesh(sizes, names)


def _t(spec):
    """A reference PartitionSpec as the port's plain tuple."""
    return tuple(spec)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list_archs())
def test_partition_specs_every_leaf(arch, smoke):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    if smoke:
        jcfg, cfg = jcfg.smoke(), cfg.smoke()
    jspecs, specs = JT.model_specs(jcfg), PT.model_specs(cfg)
    jleaves = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x,
                                                                   JP.Spec))
    leaves = T.leaves(specs)
    assert [(s.shape, s.axes) for s in leaves] == \
        [(s.shape, s.axes) for s in jleaves]
    for (sizes, names) in MESHES:
        jm, m = _meshes(sizes, names)
        want = [_t(s) for s in jax.tree.leaves(
            JP.partition_specs(jspecs, jm),
            is_leaf=lambda x: isinstance(x, PartitionSpec))]
        got = T.leaves(P.partition_specs(specs, m))
        assert got == want, (sizes, names)
        # spec_for leaf by leaf, and every spec has a DTensor placement
        for s, w in zip(leaves, want):
            assert spec_for(s.shape, s.axes, m) == w
            to_placements(w, m)


def test_sharding_rules_replace():
    jr = J_RULES.replace(ff=(), batch=("data",), kv_seq=None,
                         vocab=("model", "data"))
    r = DEFAULT_RULES.replace(ff=(), batch=("data",), kv_seq=None,
                              vocab=("model", "data"))
    assert r.table == jr.table
    assert DEFAULT_RULES.table == J_RULES.table
    shapes = [((8, 16), ("batch", "ff")), ((32, 12), ("vocab", None)),
              ((6, 4, 10), ("model_dim", "heads", "kv_seq")),
              ((9, 16), ("model_dim", "ff"))]
    for (sizes, names) in MESHES:
        jm, m = _meshes(sizes, names)
        for shape, logical in shapes:
            for jrules, rules in ((J_RULES, DEFAULT_RULES), (jr, r)):
                assert spec_for(shape, logical, m, rules) == \
                    _t(j_spec_for(shape, logical, jm, jrules))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_parity_and_copy_stack_pspecs(mesh):
    jm, m = _meshes(*mesh)
    for nb in (1, 6, 37, 48, 1200):
        for f in (3, 7):
            assert R.parity_pspec(nb, f, m) == _t(JR.parity_pspec(nb, f, jm))
    for spec in ((), (None,), ("data", None), (None, "model"),
                 (("data", "model"), None)):
        if any(a not in m.axis_names for e in spec for a in spec_axes(e)):
            continue
        for copies in (1, 2, 3):
            assert R.copy_stack_pspec(spec, m, copies) == \
                _t(JR.copy_stack_pspec(PartitionSpec(*spec), jm, copies))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list_archs())
def test_opt_spec_tree(arch, smoke):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if smoke:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    got = T.leaves(R.opt_spec_tree(PT.model_specs(cfg)))
    want = jax.tree.leaves(JR.opt_spec_tree(JT.model_specs(jcfg)),
                           is_leaf=lambda x: isinstance(x, JP.Spec))
    assert [(s.shape, s.axes, s.init) for s in got] == \
        [(s.shape, s.axes, s.init) for s in want]


@pytest.mark.parametrize("shape", [(3, 1), (6, 2), (2, 2), (4, 1), (9, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fold_copy_axis_shapes(shape):
    dev = jax.devices()[0]
    jm = JMesh(np.array([dev] * (shape[0] * shape[1])).reshape(shape),
               ("data", "model"))
    jf = j_fold(jm)
    f = fold_copy_axis(AbstractMesh(shape, ("data", "model")))
    if jf is None:
        assert f is None
        return
    assert f.axis_names == jf.axis_names
    assert f.shape == dict(jf.shape)
    assert fold_copy_axis(f) is f           # already folded


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = AbstractMesh((3, 2, 2), ("copy", "data", "model"))
    assert to_placements((("data", "model"), None), m) == \
        [Replicate(), Shard(0), Shard(0)]
    assert to_placements(("copy", None, "model"), m) == \
        [Shard(0), Replicate(), Shard(2)]
    with pytest.raises(ValueError, match="axis order"):
        to_placements((("model", "data"),), m)
    # a plain tensor is a rank's local value: constrain leaves it alone
    import torch
    x = torch.arange(4)
    assert constrain(x, "batch") is x


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_shard_slices_cover_each_leaf(mesh):
    """Summed over every rank, the slices a spec gives hold each element
    of a leaf exactly (ranks / shards) times: only its shard on each."""
    m = AbstractMesh(*mesh)
    n_ranks = int(np.prod(m.sizes))
    coords = [dict(zip(m.axis_names, c))
              for c in itertools.product(*(range(s) for s in m.sizes))]
    cfg = get_config("phi3-mini-3.8b").smoke().replace(
        n_layers=1, d_model=16, n_heads=2, n_kv=2, d_ff=32, vocab=512)
    for s in T.leaves(PT.model_specs(cfg)):
        spec = spec_for(s.shape, s.axes, m)
        shards = int(np.prod([m.shape[a] for e in spec
                              for a in spec_axes(e)] or [1]))
        hits = np.zeros(s.shape, np.int64)
        for c in coords:
            hits[shard_slices(s.shape, spec, m, c)] += 1
        assert (hits == n_ranks // shards).all(), (s.shape, spec)


@pytest.mark.parametrize("mesh", [MESHES[0], MESHES[3]], ids=["2x2", "3x1x2"])
def test_scheme_shardings(mesh):
    """`Scheme.shardings` gives, as DTensor placements, the reference's
    NamedShardings of every scheme's payload and redundancy (Compose's
    (3, n_blocks, F) parity: the per-copy table's placements one dim on)."""
    from torch.distributed.tensor import Shard
    from jax.sharding import NamedSharding
    from repro.reliability.scheme import standard_grid as j_grid
    from repro_torch.reliability.scheme import Compose, standard_grid
    jm, m = _meshes(*mesh)
    jcfg = j_get_config("phi3-mini-3.8b").smoke().replace(
        n_layers=1, d_model=16, n_heads=2, n_kv=2, d_ff=32, vocab=512)
    cfg = get_config("phi3-mini-3.8b").smoke().replace(
        n_layers=1, d_model=16, n_heads=2, n_kv=2, d_ff=32, vocab=512)
    jparams = JP.materialize(jax.random.PRNGKey(0), JT.model_specs(jcfg))
    params = P.from_numpy(jax.tree.map(np.asarray, jparams))
    jps = JP.partition_specs(JT.model_specs(jcfg), jm)
    ps = P.partition_specs(PT.model_specs(cfg), m)

    def placed(tree):
        return [to_placements(_t(ns.spec), m) for ns in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))]

    for js, s in zip(j_grid(include_hsiao=True),
                     standard_grid(include_hsiao=True)):
        want, got = js.shardings(jparams, jps, jm), s.shardings(params, ps, m)
        assert T.leaves(got.payload) == placed(want.payload), s.name
        if want.redundancy is None:
            assert got.redundancy is None
        elif isinstance(s, Compose):
            (jc, jp), ((c1, c2), p3) = want.redundancy, got.redundancy
            assert T.leaves(c1) + T.leaves(c2) == placed(jc), s.name
            per_copy = placed(jp)
            assert per_copy[0] == per_copy[1] == per_copy[2]
            assert p3 == [Shard(p.dim + 1) if isinstance(p, Shard) else p
                          for p in per_copy[0]], s.name
        elif isinstance(want.redundancy, tuple):
            assert [x for c in got.redundancy for x in T.leaves(c)] == \
                placed(want.redundancy), s.name
        else:
            assert [got.redundancy] == placed(want.redundancy), s.name


def test_require_devices_names_the_fix():
    from repro_torch.launch.mesh import make_test_mesh, require_devices
    with pytest.raises(ValueError, match="spawn"):
        require_devices(4, "test mesh 2x2")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_test_mesh(2, 2, device="cpu")
