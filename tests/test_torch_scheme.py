"""Every `standard_grid()` scheme of the port (repro_torch.reliability)
against the JAX package's: protect, corrupt with masks drawn by JAX (the
reference's per-copy, per-leaf key split of `corrupt_store` and
`FaultModel.corrupt`), then scrub or read.  Payload, redundancy and
counters must be identical bit for bit."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import arena as jarena
from repro.faults import TransientBitFlips as JFlips
from repro.reliability import standard_grid as j_grid
from repro_torch.core import tree as T
from repro_torch.faults import FaultModel
from repro_torch.models.params import from_numpy
from repro_torch.reliability import backend, parse_scheme, standard_grid


class JaxMasks(FaultModel):
    """Hands the port the word masks JAX drew, in corruption order."""

    def __init__(self, masks):
        self.masks = list(masks)

    def word_mask(self, generator, words, dt=1.0):
        m = self.masks.pop(0)
        assert m.shape == tuple(words.shape)
        return torch.from_numpy(m.view(np.int32).copy())


def jax_masks(fault, copies_of_params):
    """Masks `corrupt` draws: copy c under key c, leaf j under split(key_c,
    n_leaves)[j], over the leaf's arena words."""
    out = []
    for key_c, p in copies_of_params:
        leaves = jax.tree.leaves(p)
        for k, x in zip(jax.random.split(key_c, len(leaves)), leaves):
            out.append(np.asarray(fault.word_mask(
                k, jarena.leaf_to_words(x))))
    return out


def _params_np(seed=0):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(65, 7).astype(np.float32),
            "b": rs.randn(129).astype(ml_dtypes.bfloat16),
            "c": rs.randint(0, 100, size=(40,)).astype(np.int32),
            "d": {"e": rs.randn(33, 3).astype(np.float32)}}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.element_size() == 2
                      else torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _assert_tree_equal(got, want):
    gl, wl = T.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _assert_redundancy_equal(scheme_name, got, want):
    if got is None:
        assert want is None
    elif scheme_name.startswith("tmr"):
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif "+" in scheme_name:
        (g1, g2), gp = got
        (w1, w2), wp = want
        _assert_tree_equal(g1, w1)
        _assert_tree_equal(g2, w2)
        for g, w in zip(gp, wp):
            np.testing.assert_array_equal(_bits(g), _bits(w))
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _copies(scheme_name):
    return 3 if scheme_name.startswith("tmr") or "+" in scheme_name else 1


GRID = [s.name for s in j_grid()]


@pytest.mark.parametrize("p_bit", [0.0, 0.002, 0.02])
@pytest.mark.parametrize("name", GRID)
def test_scheme_protect_corrupt_scrub_matches_jax(name, p_bit):
    jscheme = next(s for s in j_grid() if s.name == name)
    scheme = next(s for s in standard_grid() if s.name == name)
    params_np = _params_np()
    jparams = jax.tree.map(jnp.asarray, params_np)
    key = jax.random.PRNGKey(7)
    fault = JFlips(p_bit)

    jprot = jscheme.protect(jparams)
    prot = scheme.protect(from_numpy(params_np))
    _assert_redundancy_equal(name, prot.redundancy, jprot.redundancy)

    jprot = jscheme.corrupt_store(jprot, fault, key)
    if _copies(name) == 3:
        keys = jax.random.split(key, 3)
        copies = [(k, jparams) for k in keys]
    else:
        copies = [(key, jparams)]
    masks = JaxMasks(jax_masks(fault, copies))
    prot = scheme.corrupt_store(prot, masks, None)
    assert not masks.masks
    _assert_tree_equal(prot.payload, jprot.payload)
    _assert_redundancy_equal(name, prot.redundancy, jprot.redundancy)

    # read before scrub: the payload (ECC) or the vote (TMR, Compose)
    _assert_tree_equal(scheme.read(prot), jscheme.read(jprot))

    jfixed, jrep = jscheme.scrub(jprot)
    fixed, rep = scheme.scrub(prot)
    assert fixed is prot                          # scrubbed in place
    _assert_tree_equal(fixed.payload, jfixed.payload)
    _assert_redundancy_equal(name, fixed.redundancy, jfixed.redundancy)
    for g, w in zip(rep, jrep):
        assert int(g) == int(w), (name, rep, jrep)
    if p_bit >= 0.02 and name != "unprotected":
        assert sum(int(x) for x in rep) > 0


def test_parse_scheme_names_match_jax():
    from repro.reliability import parse_scheme as j_parse
    for spec in ["off", "ecc", "ecc-wb", "tmr", "tmr-serial", "tmr-parallel",
                 "tmr-semi", "ecc+tmr", "ecc+tmr-parallel", "tmr-semi+ecc"]:
        assert parse_scheme(spec).name == j_parse(spec).name
        assert parse_scheme(spec).overhead().describe() == \
            j_parse(spec).overhead().describe()
    with pytest.raises(ValueError):
        parse_scheme("ecc+ecc")


def test_backend_resolution_order():
    assert backend.resolve("diag_parity") == "kernel"
    assert backend.resolve("tmr_vote") == "kernel"
    assert backend.resolve("tmr_vote", "torch") == "torch"
    assert backend.resolve("diag_parity", "torch") == "torch"
    with pytest.raises(ValueError):
        backend.resolve("diag_parity", "jnp")


def test_scrub_copies_with_shared_parity_matches_jax():
    """Three copies in one (3, n_words) arena against the clean arena's one
    table (the engine's Compose layout): words, per-copy corrected parity
    and counts equal the reference's `scrub_copies` of separate copies."""
    from repro.core.arena import pack as j_pack
    from repro.reliability import DiagParityEcc as JEcc
    from repro_torch.core import arena
    from repro_torch.reliability import DiagParityEcc

    params_np = _params_np(3)
    jbuf, _ = j_pack(jax.tree.map(jnp.asarray, params_np))
    jecc, ecc = JEcc(), DiagParityEcc()
    jpar = jecc.encode_arena(jbuf)
    fault = JFlips(0.01)
    jbufs = [jbuf ^ fault.word_mask(k, jbuf)
             for k in jax.random.split(jax.random.PRNGKey(5), 3)]
    want_w, want_p, want_c = jecc.scrub_copies(jbufs, [jpar] * 3)

    words, _ = arena.words_of(from_numpy(params_np))
    par = ecc.encode_arena(words)
    words3 = torch.from_numpy(np.stack([np.asarray(b).view(np.int32)
                                        for b in jbufs]))
    got_w, got_p, got_c = ecc.scrub_copies(words3, par)
    assert got_w is words3                                  # in place
    np.testing.assert_array_equal(got_w.numpy(),
                                  np.stack([_bits(w) for w in want_w]))
    np.testing.assert_array_equal(got_p.numpy(),
                                  np.stack([_bits(p) for p in want_p]))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert int(got_c.sum()) > 0
    # a second pass: nothing left to correct, the same blocks uncorrectable
    _, dropped, c2 = ecc.scrub_copies(got_w.clone(), par, keep_parity=False)
    assert dropped is None and c2.tolist() == [0, 0, int(got_c[2])]
