"""The port's transfer guard (`repro_torch.obs.count_host_transfers`)
against the JAX package's, after tests/test_obs.py (the guard and the
generation region) and tests/test_batching.py (the scheduler tick): the
same reads give the same counts on both sides; the port's engine makes
exactly one host sync -- the telemetry fetch -- over generate + fetch for
every `standard_grid()` scheme, and over a chunked generation with the
tracer on; the batcher's ticks sync only on completion ticks, once each,
and its telemetry fetch is one more."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import count_host_transfers as j_count
from repro_torch.configs import get_config
from repro_torch.faults import TransientBitFlips
from repro_torch.launch.batching import BatchSpec, ContinuousBatcher, Request
from repro_torch.launch.engine import GenerationEngine
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.obs import Tracer, count_host_transfers, fetch_telemetry
from repro_torch.reliability import parse_scheme, standard_grid

B, PROMPT, GEN = 2, 4, 6
P_BIT = 2e-3   # dense enough that scrub/vote counters are nonzero
SPEC = dict(slots=2, page_tokens=8, chunk=3, prompt_buckets=(4, 8),
            gen_cap=6)


def _cfg():
    return get_config("phi3-mini-3.8b").smoke().replace(
        n_layers=1, d_model=16, n_heads=2, n_kv=2, d_ff=32, vocab=512)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    g = torch.Generator().manual_seed(0)
    params = P.materialize(T.model_specs(cfg), g)
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=g,
                           dtype=torch.int64).to(torch.int32)
    return cfg, params, {"tokens": tokens}


def test_transfer_guard_counts_explicit_reads():
    """The reference's sequence -- a wait that moves nothing, one fetch of
    several values, two explicit reads -- counts 0, 1, 3 on both sides."""
    jx = jnp.arange(4)
    with j_count() as jl:
        jax.block_until_ready(jx)
        j0 = jl.syncs
        jax.device_get([jx, jx * 2, {"a": jx}])
        j1 = jl.syncs
        jx.tolist()
        (jx + 1).item(0)
        j3 = jl.syncs
    x = torch.arange(4, dtype=torch.int32)
    with count_host_transfers() as ledger:
        if torch.cuda.is_available():
            torch.cuda.synchronize()            # a wait, not a transfer
        assert ledger.syncs == j0 == 0
        fetch_telemetry({"tokens_emitted": x.sum(),
                         "tmr_step_disagreements": x * 2})
        assert ledger.syncs == j1 == 1
        x.tolist()
        (x + 1)[0].item()
        assert ledger.syncs == j3 == 3
        x.cpu().numpy()                          # one transfer
        np.asarray(x)                            # __array__ -> numpy: one
        assert ledger.syncs == 5
    assert any("fetch_telemetry" in s for s in ledger.sites)
    assert any("test_torch_guard" in s for s in ledger.sites)
    x.tolist()                                   # restored outside
    assert ledger.syncs == 5


@pytest.mark.parametrize("scheme", standard_grid(), ids=lambda s: s.name)
def test_generation_region_single_sync(setup, scheme):
    """generate + fetch_telemetry: exactly one host sync, every scheme."""
    cfg, params, batch = setup
    eng = GenerationEngine(cfg, scheme, gen=GEN, device="cpu")
    store, prep = eng.prepare(params, generator=torch.Generator()
                              .manual_seed(1), fault=TransientBitFlips(P_BIT))
    eng.generate(store, batch)                               # warmup
    with count_host_transfers() as ledger:
        out, telem = eng.generate(store, batch)
        stats = fetch_telemetry({**prep, **telem})
    assert ledger.syncs == 1, ledger.sites
    assert int(stats["tokens_emitted"]) == B * GEN
    if "ecc" in scheme.name:
        assert int(stats["ecc_corrected"]) > 0          # live counters


def test_chunked_region_single_sync_with_tracing(setup):
    """Chunked generation with an enabled tracer and live timeline marks
    still makes one sync: spans and marks read clocks, not tensors."""
    cfg, params, batch = setup
    eng = GenerationEngine(cfg, parse_scheme("ecc+tmr-parallel"), gen=GEN,
                           device="cpu")
    store, prep = eng.prepare(params, generator=torch.Generator()
                              .manual_seed(1), fault=TransientBitFlips(P_BIT))
    eng.generate_chunked(store, batch, chunk=2)              # warmup
    tracer = Tracer(enabled=True)
    with count_host_transfers() as ledger:
        out, telem, tl = eng.generate_chunked(store, batch, chunk=2,
                                              tracer=tracer)
        stats = fetch_telemetry({**prep, **telem})
    assert ledger.syncs == 1, ledger.sites
    assert int(stats["tokens_emitted"]) == B * GEN
    assert tl.tokens() == GEN
    assert any(e["name"] == "tmr_decode_chunk" for e in tracer.events)


def test_tick_single_transfer_contract(setup):
    """The only host sync a tick makes is ONE batched copy of finished
    rows, on ticks where a request completes; the fetch is one more."""
    cfg, params, _ = setup
    b = ContinuousBatcher(cfg, parse_scheme("ecc+tmr"), BatchSpec(**SPEC),
                          scrub_every=2, device="cpu")
    prep = b.prepare(params, generator=torch.Generator().manual_seed(1),
                     fault=TransientBitFlips(P_BIT))
    rs = np.random.RandomState(0)
    prompts = {n: rs.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (4, 8)}
    b.run([Request(99, prompts[8], 3)])                      # warmup
    reqs = [Request(0, prompts[8], 6), Request(1, prompts[4], 2),
            Request(2, prompts[8], 5), Request(3, prompts[4], 3)]
    for r in reqs:
        b.submit(r)
    completion_ticks = 0
    with count_host_transfers() as ledger:
        b.admit()
        while b.active or b.queue:
            if b.tick():
                completion_ticks += 1
            b.admit()
    assert completion_ticks > 0
    assert ledger.syncs == completion_ticks, ledger.sites
    assert completion_ticks <= b.ticks
    with count_host_transfers() as ledger2:
        stats = fetch_telemetry({**prep, **b.telemetry()})
    assert ledger2.syncs == 1, ledger2.sites
    assert int(stats["tokens_emitted"]) == 3 + sum(r.gen for r in reqs)
    assert int(stats["ecc_corrected"]) > 0
