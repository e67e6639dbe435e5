"""The port's fault-tolerant training loop (`repro_torch.runtime.TrainLoop`)
and the schemes' training hooks (`refresh`, `vote_share`, `scrub_into`,
`checkpoint_redundancy`).

Every scenario of `tests/test_runtime.py` on the port's toy loop, and
against the JAX package's loop on the same toy step (``w - 0.1 *
batch.mean()``, bit for bit in both) with the same deterministic
`inject_fn` flips: every scrub's counters, the trajectory and the
monitor's scrub fields equal the reference's under `ecc`, `hsiao`,
`tmr-parallel` and `ecc+tmr-parallel`; after every refresh the parity
equals the reference's encode of the port's params, bit for bit.
`refresh` of a store's own views re-encodes (re-copies) that arena in
place."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.obs import DEFAULT_REGISTRY as J_REGISTRY
from repro.reliability import parse_scheme as j_parse
from repro.runtime import LoopConfig as JLoopConfig
from repro.runtime import TrainLoop as JTrainLoop
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import tree as T
from repro_torch.models.params import from_numpy
from repro_torch.obs import DEFAULT_REGISTRY, fetch_telemetry
from repro_torch.reliability import backend, parse_scheme
from repro_torch.runtime import LoopConfig, TrainLoop

SCRUB_FIELDS = ("scrubs", "bits_corrected", "parity_fixed", "uncorrectable",
                "vote_disagreements", "faults_injected")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_loop(tmp_path, total=20, n=64, **kw):
    def train_step(state, batch):
        p = state["params"]["w"] - 0.1 * batch.mean()
        return {"params": {"w": p}}, {"loss": p.abs().sum()}

    state = {"params": {"w": torch.ones(n)}}
    ck = Checkpointer(str(tmp_path), keep=3, async_save=False)
    cfg = LoopConfig(total_steps=total, checkpoint_every=5, log_every=0, **kw)
    return TrainLoop(train_step, state,
                     lambda s: torch.full((4,), float(s % 3)), cfg, ckpt=ck,
                     log=lambda *_: None)


def _jax_toy_loop(tmp_path, total=20, n=64, **kw):
    def train_step(state, batch):
        p = state["params"]["w"] - 0.1 * batch.mean()
        return {"params": {"w": p}}, {"loss": jnp.abs(p).sum()}

    state = {"params": {"w": jnp.ones(n)}}
    ck = JCheckpointer(str(tmp_path), keep=3, async_save=False)
    cfg = JLoopConfig(total_steps=total, checkpoint_every=5, log_every=0,
                      **kw)
    return JTrainLoop(train_step, state, lambda s: jnp.full((4,),
                                                            float(s % 3)),
                      cfg, ckpt=ck, log=lambda *_: None)


def _flip_bits(params, positions):
    """A corrupted copy of params["w"] (the reference's `_flip_bits`)."""
    w = params["w"].clone()
    u = w.view(torch.int32)
    for idx, bit in positions:
        u[idx] ^= (1 << bit) if bit < 31 else -(1 << 31)
    return dict(params, w=w)


def _j_flip_bits(params, positions):
    w = params["w"]
    u = jax.lax.bitcast_convert_type(w, jnp.uint32)
    for idx, bit in positions:
        u = u.at[idx].set(u[idx] ^ jnp.uint32(1 << bit))
    return dict(params, w=jax.lax.bitcast_convert_type(u, jnp.float32))


# -- the scenarios of tests/test_runtime.py ----------------------------------

def test_preemption_restart_resumes_from_checkpoint(tmp_path):
    loop = _toy_loop(tmp_path)
    with pytest.raises(RuntimeError):
        loop.run(fail_at=13)
    # simulate a fresh process: new loop object, restore, continue
    loop2 = _toy_loop(tmp_path)
    assert loop2.restore()
    assert loop2.step == 10               # last checkpoint before the failure
    out = loop2.run()
    assert out["final_step"] == 20
    clean = _toy_loop(tmp_path / "clean")
    clean.run()
    assert torch.equal(loop2.state["params"]["w"],
                       clean.state["params"]["w"])


def test_ecc_scrub_in_loop_corrects_injected_flips(tmp_path):
    loop = _toy_loop(tmp_path, scrub_every=4, inject_p_bit=1e-4)
    loop.attach_scheme()
    loop.run()
    assert len(loop.scrub_reports) == 5
    total_fixed = sum(int(r.corrected) + int(r.parity_fixed)
                      for _, r in loop.scrub_reports)
    assert total_fixed >= 0               # injection is sparse; no crashes
    assert torch.isfinite(loop.state["params"]["w"]).all()


def test_loop_without_ecc_never_scrubs(tmp_path):
    loop = _toy_loop(tmp_path, scrub_every=4)
    loop.run()
    assert loop.scrub_reports == []


def test_heavy_corruption_terminates_via_restore_limit(tmp_path):
    """An uncorrectable draw must not replay identically after a restore
    (the restore count is folded into the injection seed), and the
    consecutive-restore cap guarantees termination."""
    loop = _toy_loop(tmp_path, total=12, scrub_every=2, inject_p_bit=0.2)
    loop.attach_scheme()
    out = loop.run()                 # must terminate
    assert out["final_step"] == 12
    assert loop._consecutive_scrub_restores <= loop.cfg.max_scrub_restores
    assert sum(int(r.uncorrectable) for _, r in loop.scrub_reports) > 0


def test_restore_with_legacy_parity_layout_reencodes(tmp_path):
    """A per-leaf parity tree in a snapshot is not the (n_blocks, F)
    table: restore re-encodes instead of crashing."""
    loop = _toy_loop(tmp_path, scrub_every=4)
    loop.attach_scheme()
    loop.run()
    snap = loop.ckpt.restore()
    snap["parity"] = {"w": np.asarray(snap["parity"])}
    loop.ckpt.save(loop.ckpt.latest_step(), snap, block=True)
    loop2 = _toy_loop(tmp_path, scrub_every=4)
    assert loop2.restore()
    assert loop2.parity is not None and loop2.parity.ndim == 2
    _, rep = loop2.scheme.scrub(loop2.protected)
    assert int(rep.uncorrectable) == 0


def test_fresh_process_restore_rearms_ecc(tmp_path):
    """A restore in a fresh process (no scheme attached) re-arms the scrub
    engine from the snapshot's parity."""
    loop = _toy_loop(tmp_path, scrub_every=4)
    loop.attach_scheme()
    with pytest.raises(RuntimeError):
        loop.run(fail_at=13)
    loop2 = _toy_loop(tmp_path, scrub_every=4)   # no attach_scheme
    assert loop2.restore()
    assert loop2.protected is not None
    _, rep = loop2.scheme.scrub(loop2.protected)  # parity matches the params
    assert int(rep.uncorrectable) == 0 and int(rep.corrected) == 0
    loop2.run()
    assert len(loop2.scrub_reports) > 0          # scrubbing continued


def test_fresh_process_restore_rearms_copy_scheme(tmp_path):
    """A copy-based scheme leaves no parity table, only its name: a fresh
    process re-arms it from the name."""
    loop = _toy_loop(tmp_path, scrub_every=4,
                     scheme=parse_scheme("tmr-parallel"))
    loop.attach_scheme()
    with pytest.raises(RuntimeError):
        loop.run(fail_at=13)
    logs = []
    loop2 = _toy_loop(tmp_path, scrub_every=4)
    loop2.log = logs.append
    assert loop2.restore()
    assert loop2.scheme.name == "tmr-parallel"
    assert any("re-armed protection scheme tmr-parallel" in l for l in logs)
    loop2.run()
    assert len(loop2.scrub_reports) > 0


def test_kernel_scrub_corrects_single_flips_in_loop(tmp_path):
    """One deterministic single-bit flip per interval is corrected, leaving
    training bit-exact."""
    flips = []

    def inject(params, step):
        flips.append(step)
        return _flip_bits(params, [(7, 11)])   # one bit, one block

    clean = _toy_loop(tmp_path / "clean", total=12, scrub_every=4)
    clean.run()

    loop = _toy_loop(tmp_path / "ecc", total=12, scrub_every=4)
    loop.inject_fn = inject
    loop.attach_scheme()
    assert backend.resolve("diag_parity", loop.scheme.impl) == "kernel"
    out = loop.run()
    assert flips == [4, 8, 12]
    assert sum(int(r.corrected) for _, r in loop.scrub_reports) == 3
    assert sum(int(r.uncorrectable) for _, r in loop.scrub_reports) == 0
    assert torch.equal(loop.state["params"]["w"], clean.state["params"]["w"])
    assert out["monitor"]["bits_corrected"] == 3
    assert out["scrub"]["corrected"] == 3


def test_uncorrectable_block_triggers_checkpoint_restore(tmp_path):
    """Two flips in one 32-word block defeat the single-error code; the
    monitor decision restores from the latest checkpoint."""
    logs, fired = [], []

    def inject(params, step):
        if step == 12 and not fired:          # after the step-10 checkpoint;
            fired.append(step)                # once, or the replay re-corrupts
            return _flip_bits(params, [(3, 5), (9, 21)])  # same block
        return params

    loop = _toy_loop(tmp_path, total=20, scrub_every=4)
    loop.inject_fn = inject
    loop.log = logs.append
    loop.attach_scheme()
    out = loop.run()
    assert out["final_step"] == 20
    assert any("uncorrectable" in l for l in logs)
    assert any("[restore] resumed from step 10" in l for l in logs)
    assert sum(int(r.uncorrectable) for _, r in loop.scrub_reports) == 1
    assert out["monitor"]["uncorrectable"] == 1
    assert torch.isfinite(loop.state["params"]["w"]).all()


# -- against the reference's loop ---------------------------------------------

#: (step -> flipped (word, bit)) planted by both loops' inject_fn: singles
#: in distinct blocks, a double in one block (two words), a double in one
#: word, a sign bit
PLANTS = {2: [(7, 11)], 4: [(40, 0), (100, 31)], 6: [(3, 5), (9, 21)],
          8: [(200, 3), (200, 17)], 10: [(255, 30)]}


@pytest.mark.parametrize("spec", ["ecc", "hsiao", "tmr-parallel",
                                  "ecc+tmr-parallel"])
def test_scrub_counters_match_reference(tmp_path, spec):
    def inject(params, step):
        return _flip_bits(params, PLANTS[step]) if step in PLANTS else params

    def j_inject(params, step):
        return _j_flip_bits(params, PLANTS[step]) if step in PLANTS \
            else params

    parities = []
    loop = _toy_loop(tmp_path / "port", total=12, n=256, scrub_every=2,
                     scheme=parse_scheme(spec), max_scrub_restores=0)
    ref = _jax_toy_loop(tmp_path / "ref", total=12, n=256, scrub_every=2,
                        scheme=j_parse(spec), max_scrub_restores=0)
    loop.inject_fn, ref.inject_fn = inject, j_inject
    loop.attach_scheme()
    ref.attach_scheme()
    refresh = loop._refresh

    def checked_refresh():
        refresh()
        if loop.scheme.checkpoint_redundancy:
            want = j_parse(spec).protect(jax.tree.map(
                jnp.asarray, T.map_tree(lambda x: x.numpy(),
                                        loop.state["params"])))
            parities.append(np.array_equal(
                loop.protected.redundancy.numpy().view(np.uint32),
                np.asarray(want.redundancy)))

    loop._refresh = checked_refresh
    out, jout = loop.run(), ref.run()
    assert len(loop.scrub_reports) == len(ref.scrub_reports) == 6
    for (s, r), (js, jr) in zip(loop.scrub_reports, ref.scrub_reports):
        assert s == js
        assert (int(r.corrected), int(r.parity_fixed), int(r.uncorrectable)) \
            == (int(jr.corrected), int(jr.parity_fixed),
                int(jr.uncorrectable)), (spec, s)
    assert out["scrub"] == jout["scrub"]
    assert {k: out["monitor"][k] for k in SCRUB_FIELDS} \
        == {k: jout["monitor"][k] for k in SCRUB_FIELDS}
    np.testing.assert_array_equal(loop.state["params"]["w"].numpy(),
                                  np.asarray(ref.state["params"]["w"]))
    if loop.scheme.checkpoint_redundancy:
        assert len(parities) == 12 and all(parities)


# -- the schemes' training hooks -----------------------------------------------

def _arena_params(seed=0, n=1000):
    rng = np.random.default_rng(seed)
    return from_numpy({"a": rng.standard_normal(n).astype(np.float32),
                       "b": rng.standard_normal((3, 70)).astype(np.float32)})


@pytest.mark.parametrize("spec", ["ecc", "hsiao", "tmr-parallel",
                                  "ecc+tmr-serial", "hsiao+tmr-parallel"])
def test_refresh_reencodes_own_arena_in_place(spec):
    scheme = parse_scheme(spec)
    prot = scheme.protect(_arena_params())
    words = prot.words
    for x in T.leaves(prot.payload):          # an optimizer step, in place
        x.mul_(0.5).add_(0.25)
    out = scheme.refresh(prot.payload, prot)
    assert out.words is words                 # no new arena
    fresh = scheme.protect(T.map_tree(lambda x: x.clone(), prot.payload))
    assert torch.equal(out.words, fresh.words)
    if scheme.checkpoint_redundancy:
        assert torch.equal(out.redundancy, fresh.redundancy)
    elif spec.startswith(("ecc+", "hsiao+")):
        assert torch.equal(out.redundancy[1], fresh.redundancy[1])
    # a tree that is not the store's views is protected as a fresh copy
    other = scheme.refresh(_arena_params(1), prot)
    assert other.words.data_ptr() != words.data_ptr()


@pytest.mark.parametrize("spec", ["off", "ecc", "tmr-serial",
                                  "ecc+tmr-parallel"])
def test_vote_share_and_scrub_into_match_reference(spec):
    rng = np.random.default_rng(2)
    w = rng.standard_normal(512).astype(np.float32)
    bad = w.copy()
    bad.view(np.uint32)[[5, 70, 300]] ^= np.uint32(1 << 9)
    scheme, jscheme = parse_scheme(spec), j_parse(spec)
    # copies: the port's scrub repairs its words in place, and
    # `jnp.asarray` may alias a numpy buffer
    prot = scheme.adopt({"w": torch.from_numpy(bad.copy())},
                        scheme.protect({"w": torch.from_numpy(w)}).redundancy)
    jprot = jscheme.adopt({"w": jnp.asarray(bad.copy())},
                          jscheme.protect({"w": jnp.asarray(w)}).redundancy)
    names = ["ecc_corrected", "ecc_parity_fixed", "ecc_uncorrectable",
             "tmr_final_disagreements"]
    _, metrics = scheme.scrub_into(prot, DEFAULT_REGISTRY.zeros(names))
    _, jmetrics = jscheme.scrub_into(jprot, J_REGISTRY.zeros(names))
    got, want = fetch_telemetry(metrics), J_REGISTRY.fetch(jmetrics)
    assert {k: int(v) for k, v in got.items()} \
        == {k: int(v) for k, v in want.items()}
    assert scheme.checkpoint_redundancy == jscheme.checkpoint_redundancy
    rep = scheme.scrub(scheme.protect({"w": torch.from_numpy(w)}))[1]
    vs, jvs = scheme.vote_share(rep), jscheme.vote_share(rep)
    assert (vs is None) == (jvs is None)
