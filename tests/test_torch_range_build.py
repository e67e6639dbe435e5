"""The serving store built from block ranges (`launch.placement.
build_store`): each rank fills, corrupts and scrubs only its block range
of the global arena and sends each word to the ranks whose slices hold
it, so no rank holds the whole clean arena or a whole working copy.

Held on gloo worlds on the CPU (`launch.mesh.spawn`, one intra-op thread
a rank) against today's whole-arena build -- one process's store
(`GenerationEngine.prepare` without a mesh, itself held to the JAX
package by tests/test_torch_mesh.py and tests/test_torch_engine.py)
placed on the same mesh (`shard_store`): every rank's local arena bit
for bit and every counter equal, under ``off`` / ``ecc`` / ``hsiao`` on
4x1 (llama4's serving rules: experts over data) and 2x2 (the default
rules: FSDP over data, ff / heads / vocab / experts over model), and a
folded 3x1 ``tmr-parallel`` and ``ecc+tmr-parallel`` (one copy a rank),
each on the key route (params and faults from `core.prng` keys: a rank
draws its range alone) and on the generator route (the clean arena in
hand, faults from a seeded generator), one bf16 store on the key route.
The largest storage a build allocates (`placement.LargestAllocation`) is
under the whole store's (every copy's arena); the ranks cut the chunk of
the keyed draws and of the plain block codes, whose temporaries are
fixed sizes, so that the micro arena outweighs a chunk.

Also, in this process: `FaultModel.corrupt_range` against `corrupt` for
every model on both routes (an odd-length bf16 leaf included),
`params.fill_range` against `materialize`, and `placement._boxes`.  One
world per shape: a 4-rank world runs 4x1 then 2x2, a 3-rank world the
fold, both started at once.
"""
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import _store_worker as W
from repro_torch.core import arena, prng
from repro_torch.faults import (CompositeFault, RetentionDrift,
                                StuckAtFaults, TransientBitFlips)
from repro_torch.launch import placement as PL
from repro_torch.launch.mesh import spawn
from repro_torch.models import params as P
from repro_torch.models.params import Spec

#: dense enough that every protected build corrects (and some blocks
#: hold doubles: the uncorrectable counts must agree too)
P_BIT = 2e-3
SERVE = {"model_dim": (), "expert": ("data",)}


def _runs(schemes, overrides, extra=()):
    cfg = W.micro_llama4()
    out = [(f"{s}-{r}", cfg, s, overrides, r, P_BIT, "float32")
           for s in schemes for r in ("key", "gen")]
    return out + [(name, cfg, s, overrides, r, P_BIT, dt)
                  for name, s, r, dt in extra]


RUNS = {
    (4, 1): _runs(("off", "ecc", "hsiao"), SERVE,
                  [("ecc-bf16-key", "ecc", "key", "bfloat16")]),
    (2, 2): _runs(("off", "ecc", "hsiao"), {}),
    (3, 1): _runs(("tmr-parallel", "ecc+tmr-parallel"), {}),
}
CASES = [(shape, r[0]) for shape, runs in RUNS.items() for r in runs]


@pytest.fixture(scope="module")
def worlds():
    """The 4-rank world (4x1, then 2x2 over the same ranks) and the
    3-rank fold, started at once."""
    four = [("4x1", (4, 1), W.range_builds, (RUNS[(4, 1)],)),
            ("2x2", (2, 2), W.range_builds, (RUNS[(2, 2)],))]
    three = [("3x1", (3, 1), W.range_builds, (RUNS[(3, 1)],))]
    with ThreadPoolExecutor(2) as pool:
        f4 = pool.submit(spawn, W.world, 4, args=((4, 1), four),
                         device="cpu")
        f3 = pool.submit(spawn, W.world, 3, args=((3, 1), three),
                         device="cpu")
        ranks4, ranks3 = f4.result(), f3.result()
    return {(4, 1): [r["4x1"] for r in ranks4],
            (2, 2): [r["2x2"] for r in ranks4],
            (3, 1): [r["3x1"] for r in ranks3]}


@pytest.mark.parametrize("shape,name", CASES,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n in CASES])
def test_rank_store_is_the_whole_builds_slice(worlds, shape, name):
    """Each rank's local arena equals its slices of the whole-arena build
    bit for bit, the counters equal the one process's (nonzero
    corrections under a code), and no tensor the build allocates reaches
    the whole store's size."""
    for k, r in enumerate(worlds[shape]):
        got = r[name]
        np.testing.assert_array_equal(got["words"], got["placed"],
                                      err_msg=f"rank {k}")
        assert set(got["stats"]) == set(got["ref_stats"])
        for q, v in got["ref_stats"].items():
            np.testing.assert_array_equal(got["stats"][q], v,
                                          err_msg=f"rank {k} {q}")
        if name.startswith(("ecc", "hsiao")):
            assert int(got["stats"]["ecc_corrected"]) > 0
        assert 0 < got["largest"] < got["whole"], (k, got["largest"],
                                                   got["whole"])


def test_folded_ranks_hold_one_copy_each(worlds):
    for k, r in enumerate(worlds[(3, 1)]):
        for name, got in r.items():
            assert got["held"] == (k,), name


# -- in this process -------------------------------------------------------------

def _tree():
    """Leaves of odd and even lengths (an odd bf16 leaf leaves its last
    word's top half unused) in flatten order a, b, c."""
    return {"a": Spec((7, 5), (None, None)),
            "b": Spec((3,), (None,), "ones"),
            "c": Spec((2, 33, 3), (None, None, None), "scaled")}


MODELS = [TransientBitFlips(3e-2), StuckAtFaults(2e-2, 1e-2),
          RetentionDrift(1e-2),
          CompositeFault((StuckAtFaults(1e-2, 1e-2), TransientBitFlips(2e-2)))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["key", "gen"])
@pytest.mark.parametrize("model", MODELS, ids=lambda m: type(m).__name__)
def test_corrupt_range_is_corrupts_range(model, route, dtype):
    """`corrupt_range` over any word range equals that range of the whole
    arena after `corrupt`, bit for bit, and a generator ends where
    `corrupt` leaves it (the whole copy drawn whatever the range)."""
    specs = _tree()
    params = P.materialize(specs, prng.key(1, "cpu"), dtype, "cpu")
    words, spec = arena.words_of(params)

    def source():
        return prng.key(9, "cpu") if route == "key" \
            else torch.Generator().manual_seed(9)

    whole = words.clone()
    g = source()
    model.corrupt(arena.unpack(whole, spec), g)
    assert not torch.equal(whole, words)
    after = None if route == "key" else torch.rand(4, generator=g)
    n = spec.n_words
    for lo, hi in ((0, n), (1, n - 1), (30, 70), (n - 40, n), (50, 50)):
        w = words[lo:hi].clone()
        g = source()
        model.corrupt_range(w, spec, lo, g)
        np.testing.assert_array_equal(w.numpy(), whole[lo:hi].numpy(),
                                      err_msg=f"[{lo}, {hi})")
        if after is not None:
            assert torch.equal(torch.rand(4, generator=g), after)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fill_range_is_materializes_range(dtype):
    """Any word range of `fill_range` equals that range of `materialize`
    from the same key, bit for bit (zeros, ones, normal and scaled
    leaves; pad words zero)."""
    specs = _tree()
    key = prng.key(4, "cpu")
    words, spec = arena.words_of(P.materialize(specs, key, dtype, "cpu"))
    n = spec.n_words
    for lo, hi in ((0, n), (3, 41), (32, n - 1), (n - 1, n)):
        w = torch.full((hi - lo,), 7, dtype=torch.int32)
        P.fill_range(specs, key, w, lo, dtype)
        np.testing.assert_array_equal(w.numpy(), words[lo:hi].numpy())
    src = PL.KeyedParams(specs, key, dtype, "cpu")
    assert src.spec == spec
    with pytest.raises(TypeError):
        P.fill_range(specs, torch.Generator(), w, 0, dtype)


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (2, 3, 4), (3, 1, 5, 2)])
def test_boxes_cover_a_flat_range_in_order(shape):
    """`_boxes` cuts every flat range into contiguous boxes that cover it
    exactly, in flat order."""
    n = math.prod(shape)
    flat = torch.arange(n).reshape(shape)
    for a in range(n + 1):
        for b in range(a, n + 1):
            got = []
            for off, box in PL._boxes(tuple(shape), a, b):
                part = flat[box].reshape(-1)
                assert part.tolist() == list(range(off, off + part.numel()))
                got += part.tolist()
            assert got == list(range(a, b)), (a, b)
