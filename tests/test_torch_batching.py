"""The port's continuous-batching server (repro_torch.launch.batching)
against the JAX package's on the phi3-mini smoke config (2 layers, fp32
compute): the same parameters (through `from_numpy`), the same
`poisson_trace`-style requests, the same weight fault masks (drawn by JAX
under the engine's ``fold_in(key, 100 + copy)`` convention) and the same
per-tick pool masks (drawn by JAX, handed to the port through a
`FaultModel`), under `off`, `ecc-wb`, `hsiao-wb`, `ecc+tmr-parallel` and
the fused `ecc` / `hsiao` pool exposures.

Bit for bit: every request's tokens and vote disagreements, every
telemetry counter, the scrub ticks, and the pool's syndrome table
(parity XOR encode(words)), which depends only on the faults the pool took
since each page's last refresh and on every repair since -- so it checks
the refresh timing, the copy-major page-row arithmetic and the
write-back-on-read repairs.  The pool's K/V floats themselves come out of
two frameworks' fp32 matmuls and agree within 1e-4 (the engine test's
logit tolerance), not bit for bit; the page-level arithmetic is held bit
for bit on identical pool states in `test_pool_page_ops_match_jax`.
Plus join-live == alone, the page allocator, scratch page 0, `BatchSpec`
arithmetic and the one-transfer tick."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import arena as jarena
from repro.faults import TransientBitFlips as JFlips
from repro.kernels.diag_parity import encode_parity as j_encode_diag
from repro.kernels.hsiao_secded.ref import encode_hsiao_ref as j_encode_hs
from repro.launch.batching import BatchSpec as JSpec
from repro.launch.batching import ContinuousBatcher as JBatcher
from repro.launch.batching import Request as JRequest
from repro.launch.batching import poisson_trace as j_trace
from repro.launch.batching import sequential_slot_steps as j_seq_steps
from repro.launch.engine import fetch_telemetry as j_fetch
from repro.models import params as JP
from repro.models import transformer as JT
from repro.reliability import parse_scheme as j_parse
from repro_torch.configs import get_config as get_port_config
from repro_torch.faults import FaultModel, TransientBitFlips
from repro_torch.launch.batching import (BatchSpec, ContinuousBatcher,
                                         PagedKVPool, Request,
                                         poisson_trace, sequential_slot_steps)
from repro_torch.models.params import from_numpy
from repro_torch.obs import count_host_transfers, fetch_telemetry
from repro_torch.reliability import parse_scheme, standard_grid

SPEC = dict(slots=2, page_tokens=8, chunk=3, prompt_buckets=(4, 8),
            gen_cap=6)
P_WEIGHTS = 1e-6      # a few weight flips per copy, all corrected
P_POOL = 2e-5         # ~18 pool flips a tick: live counters, none doubled
KV_TOL = 1e-4


class JaxMasks(FaultModel):
    """Hands the port the word masks JAX drew, in draw order."""

    def __init__(self, masks):
        self.masks = list(masks)

    def word_mask(self, generator, words, dt=1.0):
        m = self.masks.pop(0)
        assert m.shape == tuple(words.shape)
        return torch.from_numpy(m.view(np.int32).copy())


def _cfgs():
    cfg_j = get_config("phi3-mini-3.8b").smoke().replace(
        n_layers=2, compute_dtype="float32")
    cfg = get_port_config("phi3-mini-3.8b").smoke().replace(
        n_layers=2, compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    return cfg_j, cfg


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg = _cfgs()
    key = jax.random.PRNGKey(0)
    jparams = JP.materialize(key, JT.model_specs(cfg_j))
    params_np = jax.tree.map(np.asarray, jparams)
    rs = np.random.RandomState(0)
    prompts = {n: rs.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (4, 8)}
    return cfg_j, cfg, key, jparams, params_np, prompts


def _weight_masks(fault, key, jparams, copies):
    leaves = jax.tree.leaves(jparams)
    out = []
    for i in range(copies):
        ks = jax.random.split(jax.random.fold_in(key, 100 + i), len(leaves))
        out += [np.asarray(fault.word_mask(k, jarena.leaf_to_words(x)))
                for k, x in zip(ks, leaves)]
    return out


def _requests(R, prompts):
    """rid 9 arrives behind a full batch and joins it mid-stream."""
    return [R(0, prompts[8], 6, arrival_s=0.0),
            R(1, prompts[4], 2, arrival_s=0.0),
            R(9, prompts[8], 5, arrival_s=0.1)]


def _jax_words(jb):
    return np.asarray(jarena.pack({"k": jb.pool.k, "v": jb.pool.v})[0]
                      ).view(np.int32)


def _syndromes(words_i32, parity_i32, code):
    """parity XOR encode(words), through the JAX package's encoder."""
    w = jnp.asarray(words_i32.view(np.uint32))
    enc = j_encode_hs(w) if code == "hsiao" else j_encode_diag(w)
    return np.asarray(enc).view(np.int32) ^ parity_i32


def _serve_both(setup, name, exposure, scrub_every=2):
    """Run the JAX batcher and the port's on the same inputs; returns
    (jax batcher, jax results, jax stats, port ditto)."""
    cfg_j, cfg, key, jparams, params_np, prompts = setup
    fault = JFlips(P_WEIGHTS)
    pool_fault = JFlips(P_POOL)
    copies = 3 if "tmr" in name else 1
    tick_key = jax.random.PRNGKey(1)

    jb = JBatcher(cfg_j, j_parse(name), JSpec(**SPEC),
                  scrub_every=scrub_every)
    jprep = jb.prepare(jparams, key=key, fault=fault)
    pool_masks = []

    def jhook(b):
        k = jax.random.fold_in(tick_key, b.ticks)
        pool_masks.append(np.asarray(pool_fault.word_mask(
            k, jarena.pack({"k": b.pool.k, "v": b.pool.v})[0])))
        getattr(b.pool, exposure)(k, pool_fault)

    if exposure:
        jb.on_tick = jhook
    jres = jb.run(_requests(JRequest, prompts))
    jstats = j_fetch({**jprep, **jb.telemetry()})

    b = ContinuousBatcher(cfg, parse_scheme(name), BatchSpec(**SPEC),
                          scrub_every=scrub_every, device="cpu")
    wmasks = JaxMasks(_weight_masks(fault, key, jparams, copies))
    prep = b.prepare(from_numpy(params_np), fault=wmasks)
    assert not wmasks.masks
    pmasks = JaxMasks(pool_masks)
    if exposure:
        b.on_tick = lambda b: getattr(b.pool, exposure)(None, pmasks)
    res = b.run(_requests(Request, prompts))
    assert not pmasks.masks
    stats = fetch_telemetry({**prep, **b.telemetry()})
    return jb, jres, jstats, b, res, stats


RUNS = [("off", None), ("ecc", "inject_scrub"), ("hsiao", "inject_scrub"),
        ("ecc-wb", "corrupt"), ("hsiao-wb", "corrupt"),
        ("ecc+tmr-parallel", "inject_scrub")]


@pytest.mark.parametrize("name,exposure", RUNS, ids=[r[0] for r in RUNS])
def test_batcher_matches_jax(setup, name, exposure):
    _check_both(setup, name, exposure)


@pytest.fixture(scope="module")
def moe_setup():
    """phi3.5-moe's smoke config at 2 layers (4 experts, top-2), fp32."""
    kw = dict(n_layers=2, compute_dtype="float32")
    cfg_j = get_config("phi3.5-moe-42b-a6.6b").smoke().replace(**kw)
    cfg = get_port_config("phi3.5-moe-42b-a6.6b").smoke().replace(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    key = jax.random.PRNGKey(0)
    jparams = JP.materialize(key, JT.model_specs(cfg_j))
    params_np = jax.tree.map(np.asarray, jparams)
    rs = np.random.RandomState(0)
    prompts = {n: rs.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (4, 8)}
    return cfg_j, cfg, key, jparams, params_np, prompts


@pytest.mark.parametrize("name,exposure", [("off", None),
                                           ("ecc", "inject_scrub")],
                         ids=["off", "ecc"])
def test_moe_batcher_matches_jax(moe_setup, name, exposure):
    """The MoE family pages the same per-layer K/V as dense: the same
    checks as `test_batcher_matches_jax`."""
    _check_both(moe_setup, name, exposure)


def _check_both(setup, name, exposure):
    jb, jres, jstats, b, res, stats = _serve_both(setup, name, exposure)
    for r, j in zip(res, jres):
        assert r.rid == j.rid
        np.testing.assert_array_equal(r.tokens, np.asarray(j.tokens))
        assert r.vote_disagreements == j.vote_disagreements
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)
    assert b.scrub_ticks == jb.scrub_ticks
    assert b.ticks == jb.ticks and b.decode_slot_steps == jb.decode_slot_steps
    if name != "off":
        assert int(stats["ecc_corrected"]) > 0
        assert b.scrub_ticks
    if name.endswith("-wb"):
        assert int(stats["ecc_read_corrected"]) > 0

    # the pool: floats within the fp32 tolerance (scratch page 0 holds
    # whatever the masked rows wrote, in either order), syndromes bit-exact
    pw = b.pool.page_words
    jw, w = _jax_words(jb), b.pool.words.numpy()
    keep = np.ones(len(w) // pw, bool)
    keep[::b.spec.pool_pages + 1] = False                 # page 0 rows
    jf = jw.reshape(-1, pw)[keep].view(np.float32)
    f = w.reshape(-1, pw)[keep].view(np.float32)
    np.testing.assert_allclose(f, jf, rtol=KV_TOL, atol=KV_TOL)
    assert (jf != 0).any()
    if b.ecc is not None:
        code = "hsiao" if name.startswith("hsiao") else "ecc"
        jsyn = _syndromes(jw, np.asarray(jb.pool.parity).view(np.int32),
                          code)
        syn = _syndromes(w, b.pool.parity.numpy(), code)
        np.testing.assert_array_equal(syn, jsyn)


@pytest.mark.parametrize("copies", [False, True])
@pytest.mark.parametrize("code", ["ecc", "hsiao"])
def test_pool_page_ops_match_jax(code, copies):
    """`_refresh_parity` and `_correct_pages` on identical pool states and
    page lists (duplicates of scratch page 0 included): words, parity
    tables and counts bit for bit, including the reference's over-count
    of scratch page 0 once per duplicate."""
    cfg_j, cfg = _cfgs()
    name = code + "-wb" + ("+tmr-parallel" if copies else "")
    jb = JBatcher(cfg_j, j_parse(name), JSpec(**SPEC))
    b = ContinuousBatcher(cfg, parse_scheme(name), BatchSpec(**SPEC),
                          device="cpu")
    n = b.pool.words.numel()
    rs = np.random.RandomState(7)
    words = rs.randint(-2**31, 2**31, size=n, dtype=np.int64).astype(
        np.int32)
    pages = np.asarray([3, 0, 5, 0, 0, 6], np.int32)

    # refresh: fresh rows for `pages` over a stale table
    jkv = jarena.unpack(jnp.asarray(words.view(np.uint32)),
                        jb.pool.arena_spec)
    stale = np.asarray(jb.pool.parity)
    jpar = jb._refresh_parity(jkv["k"], jkv["v"], jnp.asarray(stale),
                              jnp.asarray(pages))
    b.pool.words.copy_(torch.from_numpy(words))
    b.pool.parity.copy_(torch.from_numpy(stale.view(np.int32).copy()))
    b._refresh_parity(torch.from_numpy(pages).long())
    np.testing.assert_array_equal(b.pool.parity.numpy(),
                                  np.asarray(jpar).view(np.int32))

    # write-back read: faults on those pages (scratch page 0 included) and
    # elsewhere, corrected against the refreshed table
    full = np.asarray(jb.pool.ecc.encode_arena(
        jnp.asarray(words.view(np.uint32)))).view(np.int32)
    bad = words.copy()
    for i in rs.choice(n, 60, replace=False):
        bad[i] ^= np.int32(1 << rs.randint(31))
    jkv = jarena.unpack(jnp.asarray(bad.view(np.uint32)), jb.pool.arena_spec)
    jk, jv, jpar2, jc = jb._correct_pages(jkv["k"], jkv["v"],
                                          jnp.asarray(full.view(np.uint32)),
                                          jnp.asarray(pages))
    b.pool.words.copy_(torch.from_numpy(bad))
    b.pool.parity.copy_(torch.from_numpy(full))
    counts = b._correct_pages(torch.from_numpy(pages).long())
    jwords = np.asarray(jarena.pack({"k": jk, "v": jv})[0]).view(np.int32)
    np.testing.assert_array_equal(b.pool.words.numpy(), jwords)
    np.testing.assert_array_equal(b.pool.parity.numpy(),
                                  np.asarray(jpar2).view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert int(counts[0]) > 0 and not np.array_equal(jwords, bad)


def _serve_alone(cfg, params, scheme, req):
    b = ContinuousBatcher(cfg, scheme, BatchSpec(**SPEC), device="cpu")
    b.prepare(params, generator=torch.Generator().manual_seed(3),
              fault=TransientBitFlips(2e-3))
    return b.run([req])[0]


GRID = list(standard_grid(include_hsiao=True)) + [
    parse_scheme(s) for s in ("ecc-wb", "hsiao-wb", "hsiao-wb+tmr-parallel")]


@pytest.mark.parametrize("scheme", GRID, ids=lambda s: s.name)
def test_join_live_batch_matches_alone(setup, scheme):
    """rid 9 arrives while both slots are busy, queues, and is admitted
    mid-stream when the short request frees its slot; its tokens and vote
    counter must equal the alone run's, under faults dense enough that the
    copies disagree."""
    _, cfg, _, _, params_np, prompts = setup
    b = ContinuousBatcher(cfg, scheme, BatchSpec(**SPEC), device="cpu")
    b.prepare(from_numpy(params_np),
              generator=torch.Generator().manual_seed(3),
              fault=TransientBitFlips(2e-3))
    res = {r.rid: r for r in b.run(_requests(Request, prompts))}
    alone = _serve_alone(cfg, from_numpy(params_np), scheme,
                         Request(9, prompts[8], 5))
    np.testing.assert_array_equal(res[9].tokens, alone.tokens)
    assert res[9].vote_disagreements == alone.vote_disagreements
    assert res[9].ttft_s > 0 and len(res[9].tokens) == 5


def test_page_allocator_reuse_and_double_free():
    _, cfg = _cfgs()
    spec = BatchSpec(**SPEC)
    pool = PagedKVPool(cfg, spec, copies=False, device="cpu")
    a = pool.alloc(3)
    assert a is not None and pool.free_pages == spec.pool_pages - 3
    assert pool.alloc(spec.pool_pages) is None    # short -> None, no change
    assert pool.free_pages == spec.pool_pages - 3
    pool.free(a)
    assert pool.free_pages == spec.pool_pages
    b = pool.alloc(3)
    assert list(b) == list(a)                     # LIFO reuse
    with pytest.raises(ValueError, match="double free"):
        pool.free(np.concatenate([b, b]))
    with pytest.raises(ValueError, match="bad page"):
        pool.free(np.asarray([0], np.int32))      # scratch is not freeable


def test_page_zero_is_scratch_and_never_read_unmasked(setup):
    """Empty slots and unreserved table entries point at page 0; filling
    it with NaN before every tick must not change a single token (the
    per-row decode zeroes K/V past each row's position)."""
    _, cfg, _, _, params_np, prompts = setup
    reqs = _requests(Request, prompts)
    outs = []
    for poison in (False, True):
        b = ContinuousBatcher(cfg, None, BatchSpec(**SPEC), device="cpu")
        b.prepare(from_numpy(params_np))
        if poison:
            def nan_page0(b):
                b.pool.k[0].fill_(float("nan"))
                b.pool.v[0].fill_(float("nan"))
            b.on_tick = nan_page0
        b.submit(reqs[1])
        b.admit()
        assert (b.table[0] == 0).sum() >= 1          # unreserved entries
        assert (b.table[1] == 0).all()               # empty slot
        assert all(p >= 1 for p in b._slots[0].pages)
        res = {r.rid: r for r in b.run([reqs[0], reqs[2]])}
        res.update(b.results)
        outs.append({k: r.tokens for k, r in res.items()})
    assert outs[0].keys() == outs[1].keys()
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


@pytest.mark.parametrize("kw", [
    dict(SPEC), dict(slots=4, page_tokens=16, chunk=8, prompt_buckets=(256,),
                     gen_cap=32),
    dict(slots=3, page_tokens=5, chunk=4, prompt_buckets=(7, 12), gen_cap=9,
         n_pages=10)])
def test_batchspec_arithmetic_matches_jax(kw):
    s, j = BatchSpec(**kw), JSpec(**kw)
    for attr in ("max_prompt", "cache_tokens", "max_pages", "pool_pages",
                 "out_cap"):
        assert getattr(s, attr) == getattr(j, attr), attr
    for plen, gen in ((4, 1), (7, 9), (12, 3), (256, 32)):
        assert s.pages_for(plen, gen) == j.pages_for(plen, gen)
    with pytest.raises(ValueError):
        BatchSpec(slots=0)


def test_full_width_pool_sizes():
    """phi3-mini at slots 4, page_tokens 16, chunk 8, bucket 256, gen_cap
    32: the sizes the server path runs at on the card."""
    cfg = get_port_config("phi3-mini-3.8b")
    spec = BatchSpec(slots=4, page_tokens=16, chunk=8, prompt_buckets=(256,),
                     gen_cap=32)
    assert (spec.cache_tokens, spec.max_pages, spec.pool_pages) == \
        (304, 19, 76)
    pool = PagedKVPool(cfg, spec, copies=False, device="meta")
    assert pool.page_words == 786432
    assert pool.arena_spec.n_words == 121110528
    pool3 = PagedKVPool(cfg, spec, copies=True, device="meta")
    assert pool3.arena_spec.n_words == 3 * 121110528


def test_poisson_trace_matches_jax():
    spec = BatchSpec(**SPEC)
    for seed in (0, 3):
        a = poisson_trace(16, rate_rps=8.0, spec=spec, vocab=512, seed=seed)
        b = j_trace(16, rate_rps=8.0, spec=JSpec(**SPEC), vocab=512,
                    seed=seed)
        for x, y in zip(a, b):
            assert (x.rid, x.gen, x.arrival_s) == (y.rid, y.gen, y.arrival_s)
            np.testing.assert_array_equal(x.prompt, y.prompt)
        assert sequential_slot_steps(a, 2) == j_seq_steps(b, 2)
        assert len({r.gen for r in a}) >= 2


def test_admission_validation_and_pool_exhaustion(setup):
    _, cfg, _, _, params_np, prompts = setup
    b = ContinuousBatcher(cfg, None, BatchSpec(**SPEC), device="cpu")
    with pytest.raises(RuntimeError, match="prepare"):
        b.submit(Request(0, prompts[4], 2))
        b.admit()
    b.prepare(from_numpy(params_np))
    with pytest.raises(ValueError, match="buckets"):
        b.submit(Request(0, np.zeros(5, np.int32), 2))
    with pytest.raises(ValueError, match="gen"):
        b.submit(Request(0, prompts[4], SPEC["gen_cap"] + 1))
    tiny = BatchSpec(slots=2, page_tokens=8, chunk=3, prompt_buckets=(8,),
                     gen_cap=6, n_pages=1)
    b2 = ContinuousBatcher(cfg, None, tiny, device="cpu")
    b2.prepare(from_numpy(params_np))
    b2.submit(Request(0, prompts[8], 6))
    with pytest.raises(RuntimeError, match="pool too small"):
        b2.drain()


def test_tick_makes_one_transfer_on_completion_ticks_only(setup):
    """The only device->host copy a tick makes is ONE batched copy of
    finished rows, and only on ticks where a request completes; the
    telemetry fetch is one more (counted by the transfer guard)."""
    _, cfg, _, _, params_np, prompts = setup
    b = ContinuousBatcher(cfg, parse_scheme("ecc+tmr"), BatchSpec(**SPEC),
                          scrub_every=2, device="cpu")
    prep = b.prepare(from_numpy(params_np),
                     generator=torch.Generator().manual_seed(1),
                     fault=TransientBitFlips(2e-3))
    for r in (Request(0, prompts[8], 6), Request(1, prompts[4], 2),
              Request(2, prompts[8], 5), Request(3, prompts[4], 3)):
        b.submit(r)
    completion_ticks = 0
    with count_host_transfers() as ledger:
        b.admit()
        while b.active or b.queue:
            if b.tick():
                completion_ticks += 1
            b.admit()
    assert 0 < completion_ticks <= b.ticks
    assert ledger.syncs == completion_ticks, ledger.sites
    assert all(site.startswith("Tensor.cpu @") for site in ledger.sites)
    with count_host_transfers() as ledger:
        stats = fetch_telemetry({**prep, **b.telemetry()})
    assert ledger.syncs == 1 and ledger.sites[0].startswith(
        "fetch_telemetry @"), ledger.sites
    assert int(stats["tokens_emitted"]) == 16
    assert int(stats["ecc_corrected"]) > 0


@pytest.mark.parametrize("copies", [False, True])
def test_corrupt_page_then_scrub_matches_jax(copies):
    """The test hook flips the same arena word as the reference's, and one
    pool scrub repairs it (one correction)."""
    cfg_j, cfg = _cfgs()
    name = "ecc+tmr-serial" if copies else "ecc"
    jb = JBatcher(cfg_j, j_parse(name), JSpec(**SPEC))
    b = ContinuousBatcher(cfg, parse_scheme(name), BatchSpec(**SPEC),
                          device="cpu")
    kw = dict(bit=31, word=5, copy=2 if copies else 0)
    jb.pool.corrupt_page(3, **kw)
    b.pool.corrupt_page(3, **kw)
    np.testing.assert_array_equal(b.pool.words.numpy(), _jax_words(jb))
    assert int((b.pool.words != 0).sum()) == 1
    counts = b.pool.scrub()
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jb.pool.scrub()))
    assert counts.tolist() == [1, 0, 0]
    assert int((b.pool.words != 0).sum()) == 0
