"""The (39,32) Hsiao SEC-DED code of the port (repro_torch.kernels.
hsiao_secded, whose wrappers take the plain version for a CPU tensor)
against the JAX package's Pallas kernels (interpret mode) and its oracle,
bit for bit -- words, check tables and per-word counts -- on random words,
planted single data-bit flips, check-bit flips, same-word doubles (detected,
left as they are) and different-word doubles (both corrected); the
shared-table 3-copy scrub; the scheme tokens and grid; plain emulations
of the CUDA encode's and scrub's bit-sliced arithmetic (rotated read
order, 32x32 bit transpose, XOR of bit-planes, rotation back or sparse
classification) against the JAX kernels; plus the CUDA kernels against
the plain versions on the card, and their refusals (skipped without
one)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import hsiao_secded as H
from repro_torch.kernels.hsiao_secded.ref import syndrome_classes
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


# ---------------------------------------------------------------------------
# The CUDA scrub's arithmetic (csrc/hsiao_secded.cu), emulated in numpy over
# all blocks at once.  Thread t of a 32-block tile owns block t; it loads
# its block with eight 16-byte reads, chunk c from chunk (c + t) mod 8, so
# a[i] = w_((i + r) mod 32) with r = 4t mod 32; transposes the 32x32 bit
# matrix (two rounds of byte permutes, three of masked merges); XORs the
# bit-planes of each check mask with the stored row rotated right by r;
# and classifies only the words whose syndrome is nonzero.

U32 = np.uint32


def _rotl(x, r):
    x = np.asarray(x, dtype=np.uint64)
    r = np.asarray(r, dtype=np.int64) % 32
    out = (x << r.astype(np.uint64)) | (x >> ((32 - r) % 32).astype(np.uint64))
    return (out & 0xFFFFFFFF).astype(U32)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte n of the result is byte (sel >> 4n) & 7 of
    the 8-byte value y:x."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(v)
    for n in range(4):
        b = (sel >> (4 * n)) & 7
        out |= ((v >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(U32)


def _kernel_order(w):
    """(n, 32) words as the kernel's threads hold them, and each block's r."""
    n = w.size // BLOCK
    t = np.arange(n) % BLOCK                 # the block's thread in its tile
    i = np.arange(BLOCK)
    idx = 4 * ((i[None, :] // 4 + t[:, None]) % 8) + i[None, :] % 4
    a = w.reshape(n, BLOCK)[np.arange(n)[:, None], idx]
    return a, (4 * t) % BLOCK


def _transpose32(a):
    """The kernel's five swap rounds over (n, 32): afterwards bit i of
    a[:, k] is bit k of the old a[:, i]."""
    a = a.copy()
    for J in (16, 8, 4, 2, 1):
        M = U32({4: 0x0F0F0F0F, 2: 0x33333333, 1: 0x55555555}.get(J, 0))
        for p in range(BLOCK // 2):
            k = p // J * 2 * J + p % J
            x, y = a[:, k].copy(), a[:, k + J].copy()
            if J == 16:
                a[:, k], a[:, k + J] = (_byte_perm(x, y, 0x5410),
                                        _byte_perm(x, y, 0x7632))
            elif J == 8:
                a[:, k], a[:, k + J] = (_byte_perm(x, y, 0x6240),
                                        _byte_perm(x, y, 0x7351))
            else:
                a[:, k] = (x & M) | ((y << U32(J)) & ~M)
                a[:, k + J] = ((x >> U32(J)) & M) | (y & ~M)
    return a


def _sliced_rows(w):
    """(check rows in the rotated frame (n, 7), r (n,)) of words w."""
    a, r = _kernel_order(w)
    planes = _transpose32(a)
    rows = np.zeros((len(a), H.N_CHECKS), U32)
    for j, m in enumerate(H.CHECK_MASKS):
        for k in range(BLOCK):
            if (m >> k) & 1:
                rows[:, j] ^= planes[:, k]
    return rows, r


def emulate_bitsliced_encode(words):
    """The kernel's encode of uint32 `words`: each thread's block in the
    staged read order, transposed, the bit-planes of each check mask XORed
    (the rows the scrub forms too), rotated back to word order by r.
    Returns the (n, 7) check table, numpy."""
    rows, r = _sliced_rows(words)
    return _rotl(rows, r[:, None])


def emulate_bitsliced_scrub(words, parity, out=None):
    """The kernel's scrub of uint32 `words` against `parity` (row b mod
    len(parity)); corrected rows to `out` (every row), else in place when
    the table is per block, else dropped.  Returns (words, parity rows or
    None, counts), numpy."""
    words = words.copy()
    n, npb = words.size // BLOCK, parity.shape[0]
    rows, r = _sliced_rows(words)
    stored = parity[np.arange(n) % npb]
    syn = rows ^ _rotl(stored, -r[:, None])
    dirty = np.bitwise_or.reduce(syn, axis=1)
    lut = syndrome_classes()
    counts = np.zeros(3, np.int32)
    fixed = stored.copy()
    healed = np.zeros(n, bool)
    for b in np.flatnonzero(dirty):
        for i in range(BLOCK):
            if not (int(dirty[b]) >> i) & 1:
                continue
            s = sum(((int(syn[b, j]) >> i) & 1) << j
                    for j in range(H.N_CHECKS))
            cls, wi = lut[s], (i + int(r[b])) % BLOCK
            if cls < BLOCK:
                words[b * BLOCK + wi] ^= U32(1 << cls)
                counts[0] += 1
            elif cls < 32 + H.N_CHECKS:
                fixed[b, cls - 32] ^= U32(1 << wi)
                healed[b] = True
                counts[1] += 1
            else:
                counts[2] += 1
    if out is not None:                 # every row
        return words, fixed, counts
    if npb == n:                        # in place, healed rows only
        parity = parity.copy()
        parity[healed] = fixed[healed]
        return words, parity, counts
    return words, None, counts          # dropped


def test_kernel_read_order_and_transpose():
    """Every one of a tile's 32 threads holds w_((i + 4t) mod 32) at
    register i, and the transpose puts bit k of word i at bit i of plane
    k."""
    w = _words(BLOCK, 3)
    a, r = _kernel_order(w)
    assert sorted(set(r.tolist())) == list(range(0, BLOCK, 4))
    for t in range(BLOCK):
        blk = w[t * BLOCK:(t + 1) * BLOCK]
        np.testing.assert_array_equal(a[t], blk[(np.arange(BLOCK) + r[t])
                                                % BLOCK])
    planes = _transpose32(a)
    bits = (a[:, :, None] >> np.arange(BLOCK, dtype=U32)) & 1   # [t, i, k]
    want = (bits.transpose(0, 2, 1).astype(np.uint64)
            << np.arange(BLOCK, dtype=np.uint64)).sum(-1).astype(U32)
    np.testing.assert_array_equal(planes, want)


def test_compiled_check_masks_equal_code():
    """The scrub's XOR trees are compiled from constants in the CUDA source;
    they must be the code's CHECK_MASKS."""
    src = (Path(H.__file__).resolve().parents[1] / "csrc" /
           "hsiao_secded.cu").read_text()
    body = src[src.index("constexpr uint32_t check_mask"):]
    body = body[:body.index("}")]
    got = tuple(int(x, 16) for x in re.findall(r"0x([0-9A-Fa-f]{8})u", body))
    assert got == H.CHECK_MASKS


@pytest.mark.parametrize("n_blocks", [1, 33, 70])
def test_bitsliced_check_rows_match_jax_encode(n_blocks):
    """The rows rotated back by r are the JAX encode kernel's check table."""
    w = _words(n_blocks, 40 + n_blocks)
    rows, r = _sliced_rows(w)
    want = np.asarray(JH.encode_hsiao(jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(_rotl(rows, r[:, None]), want)


@pytest.mark.parametrize("n_blocks", [1, 5, 31, 32, 45, 97])
def test_bitsliced_encode_emulation_matches_jax(n_blocks):
    """The encode kernel's arithmetic, tiles of 32 blocks with tails of
    fewer, against the JAX encode kernel in interpret mode."""
    w = _words(n_blocks, 60 + n_blocks)
    want = np.asarray(JH.encode_hsiao(jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(emulate_bitsliced_encode(w), want)


def _sliced_case(kind, seed, n=70):
    """(corrupted words, corrupted table) over n blocks, so that every
    thread position of a tile and a tail past one tile are covered."""
    rs = np.random.RandomState(seed)
    w = _words(n, seed)
    p = H.encode_hsiao_ref(_to_t(w)).numpy().view(np.uint32).copy()
    blocks = rs.choice(n, 40, replace=False)
    if kind == "single_data":                    # 3 words in each block
        for b in blocks:
            for i in rs.choice(BLOCK, 3, replace=False):
                _flip(w, b * BLOCK + i, rs.randint(32))
    elif kind == "one_flip_every_word":
        for b in blocks[:10]:
            for i in range(BLOCK):
                _flip(w, b * BLOCK + i, rs.randint(32))
    elif kind == "check_bit":
        for b in blocks:                         # 1 or 2 words per row
            for i in rs.choice(BLOCK, 1 + b % 2, replace=False):
                p[b, rs.randint(7)] ^= np.uint32(1 << i)
    elif kind == "same_word_double":
        for b in blocks:
            i, k = rs.randint(BLOCK), rs.choice(32, 2, replace=False)
            _flip(w, b * BLOCK + i, k[0])
            _flip(w, b * BLOCK + i, k[1])
            _flip(w, b * BLOCK + (i + 1) % BLOCK, rs.randint(32))
    elif kind == "different_word_double":
        for b in blocks:
            for i in rs.choice(BLOCK, 2, replace=False):
                _flip(w, b * BLOCK + i, 9)
    elif kind == "fuzz":
        for _ in range(300):
            _flip(w, rs.randint(n * BLOCK), rs.randint(32))
        for _ in range(20):
            p[rs.randint(n), rs.randint(7)] ^= np.uint32(1 << rs.randint(32))
    return w, p


@pytest.mark.parametrize("kind", KINDS)
def test_bitsliced_scrub_emulation_matches_jax(kind):
    bad, p = _sliced_case(kind, 50 + KINDS.index(kind))
    jw, jp, jc = (np.asarray(x) for x in JH.scrub(
        jnp.asarray(bad), jnp.asarray(p), interpret=True))
    ow, _, oc = (np.asarray(x) for x in j_scrub_ref(jnp.asarray(bad),
                                                    jnp.asarray(p)))
    ew, ep, ec = emulate_bitsliced_scrub(bad, p)
    np.testing.assert_array_equal(ew, jw)
    np.testing.assert_array_equal(ew, ow)
    np.testing.assert_array_equal(ep, jp)
    np.testing.assert_array_equal(ec, jc)
    np.testing.assert_array_equal(ec, oc)
    if kind == "same_word_double":
        assert ec.tolist() == [40, 0, 40]
    if kind == "different_word_double":
        assert ec.tolist() == [80, 0, 0]
    if kind == "one_flip_every_word":
        assert ec.tolist() == [320, 0, 0]


@pytest.mark.parametrize("layout", ["out_all", "shared3_dropped"])
def test_bitsliced_scrub_emulation_shared_table_matches_jax(layout):
    """Three copies against one table, rows written for every block or
    dropped: the JAX scrub of the concatenated copies and tables."""
    bad, p = _sliced_case("fuzz", 77)
    rs = np.random.RandomState(78)
    copies = [bad.copy() for _ in range(3)]
    for c in copies[1:]:
        for _ in range(100):
            _flip(c, rs.randint(c.size), rs.randint(32))
    words = np.concatenate(copies)
    jw, jp, jc = (np.asarray(x) for x in JH.scrub(
        jnp.asarray(words), jnp.asarray(np.concatenate([p] * 3)),
        interpret=True))
    out = np.zeros_like(np.concatenate([p] * 3)) if layout == "out_all" \
        else None
    ew, ep, ec = emulate_bitsliced_scrub(words, p, out)
    np.testing.assert_array_equal(ew, jw)
    np.testing.assert_array_equal(ec, jc)
    if out is None:
        assert ep is None
    else:
        np.testing.assert_array_equal(ep, jp)


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


# Edge cases of the thread-per-block scrub on the card: a warp tile is 32
# blocks, so 1, 33 and 45 blocks leave tails; corrected rows in place, for
# every row, for three copies against one table, or dropped.  Each block
# carries one of: a single data-bit error in one word, one in every word,
# a check-bit error, a same-word double, a different-word double, nothing.
EDGE_BLOCKS = [1, 33, 45]
EDGE_LAYOUTS = ["in_place", "out_all", "shared3_out", "shared3_dropped"]


def _plant_edge(w, p, n, rs, shift=0):
    for b in range(n):
        kind = (b + shift) % 6
        if kind == 0:
            _flip(w, b * BLOCK + rs.randint(BLOCK), rs.randint(32))
        elif kind == 1:
            for i in range(BLOCK):
                _flip(w, b * BLOCK + i, rs.randint(32))
        elif kind == 2 and p is not None:
            p[b, rs.randint(7)] ^= np.uint32(1 << rs.randint(32))
        elif kind == 3:
            i, k = rs.randint(BLOCK), rs.choice(32, 2, replace=False)
            _flip(w, b * BLOCK + i, k[0])
            _flip(w, b * BLOCK + i, k[1])
        elif kind == 4:
            for i in rs.choice(BLOCK, 2, replace=False):
                _flip(w, b * BLOCK + i, rs.randint(32))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", EDGE_LAYOUTS)
@pytest.mark.parametrize("n_blocks", EDGE_BLOCKS)
def test_kernel_edge_cases_match_plain_on_card(n_blocks, layout):
    dev = _cuda()
    rs = np.random.RandomState(n_blocks)
    w = _words(n_blocks, n_blocks)
    p = H.encode_hsiao_ref(_to_t(w)).numpy().view(np.uint32).copy()
    copies = 3 if layout.startswith("shared3") else 1
    bufs = [w.copy() for _ in range(copies)]
    for c, wc in enumerate(bufs):
        _plant_edge(wc, p if c == 0 else None, n_blocks, rs, shift=c)
    words = np.concatenate(bufs)
    out = None if layout in ("in_place", "shared3_dropped") else \
        np.zeros((copies * n_blocks, 7), np.uint32)
    want = H.scrub_hsiao_ref(_to_t(words), _to_t(p),
                             None if out is None else _to_t(out))
    buf, par = _to_t(words).to(dev), _to_t(p).to(dev)
    out_t = None if out is None else _to_t(out).to(dev)
    _, got_p, counts = H.scrub(buf, par, out_parity=out_t)
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), want[0])
    assert torch.equal(counts.cpu(), want[2])
    if layout == "shared3_dropped":
        assert got_p is None and want[1] is None
    else:
        assert torch.equal(got_p.cpu(), want[1])
    if layout == "in_place":
        assert got_p is par


@pytest.mark.gpu
def test_kernel_rejects_misaligned_buffer_on_card():
    dev = _cuda()
    words = _to_t(_words(3, 5)).to(dev)
    par = H.encode_hsiao(words[:64])
    with pytest.raises(RuntimeError):
        H.scrub(words[1:65], par)       # 4 bytes past the allocation's start


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks", [1, 31, 32, 33, 45, 4099])
def test_encode_edge_shapes_match_plain_on_card(n_blocks):
    """Tails past a 32-block tile, and a page-like view that starts on a
    block boundary inside a larger buffer."""
    dev = _cuda()
    w = _to_t(_words(n_blocks + 3, n_blocks)).to(dev)
    for view in (w[:n_blocks * BLOCK], w[3 * BLOCK:]):
        got = H.encode_hsiao(view)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), H.encode_hsiao_ref(view.cpu()))


@pytest.mark.gpu
def test_encode_rejects_misaligned_buffer_on_card():
    dev = _cuda()
    words = _to_t(_words(3, 6)).to(dev)
    with pytest.raises(RuntimeError):
        H.encode_hsiao(words[1:65])     # 4 bytes past the allocation's start


@pytest.mark.gpu
def test_encode_rejects_foreign_masks_on_card():
    """The check rows' XOR trees are compiled in: the C entry points refuse
    any other masks (and the scrub too)."""
    import ctypes
    from repro_torch.kernels.hsiao_secded import kernel as K
    dev = _cuda()
    words = _to_t(_words(2, 7)).to(dev)
    parity = torch.zeros((2, 7), dtype=torch.int32, device=dev)
    masks = list(H.CHECK_MASKS)
    masks[3] ^= 1
    foreign = (ctypes.c_uint32 * 7)(*masks)
    lib = K._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert lib.hsiao_encode(words.data_ptr(), 2, parity.data_ptr(), foreign,
                            K._COLUMNS, stream) != 0
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    assert lib.hsiao_scrub(words.data_ptr(), 2, parity.data_ptr(), 2, None,
                           0, foreign, K._COLUMNS, counts.data_ptr(),
                           stream) != 0
    assert lib.hsiao_encode(words.data_ptr(), 2, parity.data_ptr(),
                            K._MASKS, K._COLUMNS, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(parity.cpu(), H.encode_hsiao_ref(words.cpu()))
