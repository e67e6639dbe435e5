"""The (39,32) Hsiao SEC-DED code of the port (repro_torch.kernels.
hsiao_secded, whose wrappers take the plain version for a CPU tensor)
against the JAX package's Pallas kernels (interpret mode) and its oracle,
bit for bit -- words, check tables and per-word counts -- on random words,
planted single data-bit flips, check-bit flips, same-word doubles (detected,
left as they are) and different-word doubles (both corrected); the
shared-table 3-copy scrub; the scheme tokens and grid; plus the CUDA
kernels against the plain versions on the card (skipped without one)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import hsiao_secded as H
from repro_torch.reliability import parse_scheme, standard_grid

try:    # without JAX (as on a GPU machine) only the kernel cases run
    import jax.numpy as jnp
    from repro.kernels import hsiao_secded as JH
    from repro.kernels.hsiao_secded.ref import scrub_hsiao_ref as j_scrub_ref
    from repro.reliability import parse_scheme as j_parse
    from repro.reliability import standard_grid as j_grid
except ImportError:
    jnp = None

BLOCK = 32


def _words(n_blocks, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2**32, size=n_blocks * BLOCK,
                      dtype=np.uint64).astype(np.uint32)


def _to_t(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.view(np.int32).copy())


def _flip(u32: np.ndarray, idx: int, bit: int) -> None:
    u32[idx] ^= np.uint32(1 << bit)


def test_constants_equal_reference():
    assert H.N_CHECKS == JH.N_CHECKS
    assert H.DATA_COLUMNS == JH.DATA_COLUMNS
    assert H.CHECK_MASKS == JH.CHECK_MASKS


@pytest.mark.parametrize("n_blocks", [1, 5, 64])
def test_encode_matches_jax(n_blocks):
    w = _words(n_blocks, n_blocks)
    want = np.asarray(JH.encode_hsiao(jnp.asarray(w), interpret=True))
    got = H.encode_hsiao(_to_t(w))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def _case(kind, seed):
    """(corrupted words, corrupted check table) for one planted case."""
    rs = np.random.RandomState(seed)
    n = 6
    w = _words(n, seed)
    p = H.encode_hsiao_ref(_to_t(w)).numpy().view(np.uint32).copy()
    if kind == "single_data":
        for i in rs.choice(n * BLOCK, 20, replace=False):
            _flip(w, i, rs.randint(32))
    elif kind == "one_flip_every_word":
        for i in range(BLOCK):                       # one per word of block 2
            _flip(w, 2 * BLOCK + i, (3 * i) % 32)
    elif kind == "check_bit":
        p[1, 0] ^= np.uint32(1 << 7)
        p[4, 6] ^= np.uint32(1 << 31)
    elif kind == "same_word_double":
        _flip(w, 3 * BLOCK + 5, 1)
        _flip(w, 3 * BLOCK + 5, 30)
        _flip(w, 0, 4)                               # plus a correctable one
    elif kind == "different_word_double":
        _flip(w, 1 * BLOCK + 2, 9)
        _flip(w, 1 * BLOCK + 17, 9)
    elif kind == "fuzz":
        for _ in range(60):
            _flip(w, rs.randint(n * BLOCK), rs.randint(32))
        for _ in range(4):
            p[rs.randint(n), rs.randint(7)] ^= np.uint32(1 << rs.randint(32))
    return w, p


KINDS = ["clean", "single_data", "one_flip_every_word", "check_bit",
         "same_word_double", "different_word_double", "fuzz"]


@pytest.mark.parametrize("kind", KINDS)
def test_scrub_matches_jax(kind):
    bad, p = _case(kind, KINDS.index(kind))
    jw, jp, jc = (np.asarray(x) for x in JH.scrub(
        jnp.asarray(bad), jnp.asarray(p), interpret=True))
    ow, op, oc = (np.asarray(x) for x in j_scrub_ref(jnp.asarray(bad),
                                                     jnp.asarray(p)))
    np.testing.assert_array_equal(jw, ow)            # the two JAX paths
    buf, par = _to_t(bad), _to_t(p)
    out, out_p, counts = H.scrub(buf, par)
    assert out is buf and out_p is par               # in place
    np.testing.assert_array_equal(buf.numpy(), jw.view(np.int32))
    np.testing.assert_array_equal(par.numpy(), jp.view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), jc)
    np.testing.assert_array_equal(counts.numpy(), oc)
    if kind == "same_word_double":
        assert counts.tolist() == [1, 0, 1]
        assert buf.numpy().view(np.uint32)[3 * BLOCK + 5] == \
            bad[3 * BLOCK + 5]                       # left as it was
    if kind == "different_word_double":
        assert counts.tolist() == [2, 0, 0]
    if kind == "one_flip_every_word":
        assert counts.tolist() == [32, 0, 0]
    if kind == "check_bit":
        assert counts.tolist() == [0, 2, 0]


def test_shared_table_three_copy_scrub_matches_jax():
    """Three copies in one buffer against one clean table (row b mod n):
    the same words, per-copy rows and summed counts as the reference's
    scrub of the concatenated copies and tables."""
    w = _words(7, 11)
    p = H.encode_hsiao_ref(_to_t(w)).numpy().view(np.uint32)
    copies = [w.copy() for _ in range(3)]
    _flip(copies[0], 3, 4)
    _flip(copies[1], 2 * BLOCK + 1, 31)
    _flip(copies[1], 2 * BLOCK + 1, 2)           # word double in copy 1
    _flip(copies[2], 6 * BLOCK + 31, 17)
    _flip(copies[2], 6 * BLOCK + 30, 17)
    jw, jp, jc = (np.asarray(x) for x in JH.scrub(
        jnp.asarray(np.concatenate(copies)),
        jnp.asarray(np.concatenate([p] * 3)), interpret=True))
    buf = _to_t(np.concatenate(copies))
    out_p = torch.empty((3 * p.shape[0], 7), dtype=torch.int32)
    _, got_p, counts = H.scrub(buf, _to_t(p), out_parity=out_p)
    np.testing.assert_array_equal(buf.numpy(), jw.view(np.int32))
    np.testing.assert_array_equal(got_p.numpy(), jp.view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), jc)
    assert counts.tolist() == [3, 0, 1]
    buf2 = _to_t(np.concatenate(copies))
    _, none_p, counts2 = H.scrub(buf2, _to_t(p))     # rows dropped
    assert none_p is None and torch.equal(buf2, buf)
    assert torch.equal(counts2, counts)


def test_scheme_tokens_and_grid_match_jax():
    for spec in ["hsiao", "hsiao-wb", "hsiao+tmr", "hsiao+tmr-parallel",
                 "tmr-semi+hsiao", "hsiao-wb+tmr-serial"]:
        assert parse_scheme(spec).name == j_parse(spec).name
        assert parse_scheme(spec).overhead().describe() == \
            j_parse(spec).overhead().describe()
    assert parse_scheme("hsiao-wb").write_back
    assert parse_scheme("ecc-wb").write_back
    assert [s.name for s in standard_grid(include_hsiao=True)] == \
        [s.name for s in j_grid(include_hsiao=True)]
    assert [s.name for s in standard_grid()] == [s.name for s in j_grid()]
    with pytest.raises(ValueError):
        parse_scheme("hsiao+ecc")


def test_scheme_inject_scrub_arena_default_matches_jax():
    """Hsiao has no dedicated fused kernel: XOR then scrub, counts (4,)
    with `injected` first -- the reference's default path."""
    from repro.reliability import HsiaoSecDed as JHsiao
    w = _words(8, 21)
    rs = np.random.RandomState(21)
    mask = np.zeros_like(w)
    for i in rs.choice(w.size, 40, replace=False):
        mask[i] |= np.uint32(1 << rs.randint(32))
    jecc = JHsiao()
    jpar = jecc.encode_arena(jnp.asarray(w))
    jw, jp, jc = (np.asarray(x) for x in jecc.inject_scrub_arena(
        jnp.asarray(w), jpar, jnp.asarray(mask)))
    ecc = parse_scheme("hsiao")
    buf = _to_t(w)
    par = ecc.encode_arena(buf)
    _, par, counts = ecc.inject_scrub_arena(buf, par, _to_t(mask))
    np.testing.assert_array_equal(buf.numpy(), jw.view(np.int32))
    np.testing.assert_array_equal(par.numpy(), jp.view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), jc)
    assert int(counts[0]) == 40 and int(counts[1]) > 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(kind):
    dev = _cuda()
    bad, p = _case(kind, KINDS.index(kind))
    assert torch.equal(H.encode_hsiao(_to_t(bad).to(dev)).cpu(),
                       H.encode_hsiao_ref(_to_t(bad)))
    want_w, want_p, want_c = H.scrub_hsiao_ref(_to_t(bad), _to_t(p))
    buf, par = _to_t(bad).to(dev), _to_t(p).to(dev)
    _, got_p, counts = H.scrub(buf, par)
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), want_w)
    assert torch.equal(got_p.cpu(), want_p)
    assert torch.equal(counts.cpu(), want_c)


@pytest.mark.gpu
def test_kernel_shared_table_matches_plain_on_card():
    dev = _cuda()
    w = _words(4099, 5)
    p = H.encode_hsiao_ref(_to_t(w))
    rs = np.random.RandomState(5)
    w3 = np.concatenate([w] * 3)
    for i in rs.choice(w3.size, 3000, replace=False):
        _flip(w3, i, rs.randint(32))
    want = _to_t(w3)
    want_p = torch.empty((3 * p.shape[0], 7), dtype=torch.int32)
    _, _, want_c = H.scrub_hsiao_ref(want, p, want_p)
    buf = _to_t(w3).to(dev)
    out_p = torch.empty((3 * p.shape[0], 7), dtype=torch.int32, device=dev)
    _, _, counts = H.scrub(buf, p.to(dev), out_parity=out_p)
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), want) and torch.equal(out_p.cpu(), want_p)
    assert torch.equal(counts.cpu(), want_c)


@pytest.mark.parametrize("spec", ["hsiao-wb", "ecc-wb"])
def test_read_corrected_matches_jax(spec):
    """`ArenaEcc.read_corrected`: corrected payload, the corrected store
    kept (in place here), and the scrub report, as the reference."""
    import jax
    from repro_torch.core import arena
    from repro_torch.models.params import from_numpy
    rs = np.random.RandomState(2)
    params_np = {"a": rs.randn(64, 9).astype(np.float32),
                 "b": rs.randn(33).astype(np.float32)}
    jscheme, scheme = j_parse(spec), parse_scheme(spec)
    jprot = jscheme.protect(jax.tree.map(jnp.asarray, params_np))
    prot = scheme.protect(from_numpy(params_np))
    flips = rs.choice(prot.words.numel() - 40, 12, replace=False)
    bad = {k: v.copy() for k, v in params_np.items()}
    for i in flips:                      # flip words of leaf "a" only
        bad["a"].view(np.uint32).reshape(-1)[i % bad["a"].size] ^= \
            np.uint32(1 << (i % 32))
    jprot = jscheme.adopt(jax.tree.map(jnp.asarray, bad), jprot.redundancy)
    arena.words_of(prot.payload)[0].copy_(
        arena.words_of(from_numpy(bad))[0])
    jpay, _, jrep = jscheme.read_corrected(jprot)
    pay, prot2, rep = scheme.read_corrected(prot)
    assert prot2 is prot
    for k in params_np:
        np.testing.assert_array_equal(pay[k].numpy().view(np.int32),
                                      np.asarray(jpay[k]).view(np.int32))
    assert [int(x) for x in rep] == [int(x) for x in jrep]
    assert int(rep[0]) > 0
