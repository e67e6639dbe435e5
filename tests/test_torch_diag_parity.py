"""Diagonal-parity encode and scrub: the port's plain versions
(repro_torch.kernels.diag_parity, which a CPU tensor takes) against the
JAX package's `encode_parity` (Pallas, interpret mode) and `scrub_ref`,
bit for bit -- words, parity and counts -- under 0, 1 and 2 data flips and
parity-word flips; a plain emulation of the CUDA encode's thread-per-block
Horner arithmetic against the JAX encode kernel; plus the CUDA kernels
against the plain versions on the card (skipped without one)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import diag_parity as D

try:    # without JAX (as on a GPU machine) only the kernel cases run
    import jax.numpy as jnp
    from repro.kernels.diag_parity import encode_parity as j_encode
    from repro.kernels.diag_parity import scrub_ref as j_scrub
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


@pytest.mark.parametrize("n_blocks", [1, 7, 64])
@pytest.mark.parametrize("slopes", [(1, 2, -1), (1, 2), (1, 2, -1, 3)])
def test_encode_matches_jax(n_blocks, slopes):
    w = _words(n_blocks, n_blocks)
    want = np.asarray(j_encode(jnp.asarray(w), slopes=slopes))
    got = D.encode_parity(_to_t(w), slopes)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def _case(kind, seed):
    """(clean words, corrupted words, corrupted parity) for one case."""
    rs = np.random.RandomState(seed)
    n = 9
    w = _words(n, seed)
    p = D.encode_parity_ref(_to_t(w)).numpy().view(np.uint32).copy()
    bad = w.copy()
    if kind == "one_data_flip":
        for b in (0, 4, 8):
            _flip(bad, b * BLOCK + rs.randint(BLOCK), rs.randint(32))
    elif kind == "two_data_flips":
        _flip(bad, 2 * BLOCK + 3, 5)
        _flip(bad, 2 * BLOCK + 17, 30)
        _flip(bad, 5 * BLOCK + 1, 0)             # plus a correctable block
    elif kind == "parity_word_flip":
        p[1, 0] ^= np.uint32(1 << 7)
        p[3, 2] ^= np.uint32(1 << 31)
        p[6, 1] ^= np.uint32(3)                  # two bits: uncorrectable
    elif kind == "mixed":
        for _ in range(12):
            _flip(bad, rs.randint(n * BLOCK), rs.randint(32))
        p[rs.randint(n), rs.randint(3)] ^= np.uint32(1 << rs.randint(32))
    return w, bad, p


KINDS = ["clean", "one_data_flip", "two_data_flips", "parity_word_flip",
         "mixed"]


@pytest.mark.parametrize("kind", KINDS)
def test_scrub_matches_jax(kind):
    _, bad, p = _case(kind, KINDS.index(kind))
    want_w, want_p, want_c = (np.asarray(x) for x in
                              j_scrub(jnp.asarray(bad), jnp.asarray(p)))
    buf, par = _to_t(bad), _to_t(p)
    out, out_p, counts = D.scrub(buf, par)
    assert out is buf and out_p is par                    # in place
    np.testing.assert_array_equal(buf.numpy(), want_w.view(np.int32))
    np.testing.assert_array_equal(par.numpy(), want_p.view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), want_c)
    if kind != "clean":
        assert counts.sum().item() > 0


def test_scrub_of_stacked_copies_with_shared_parity():
    """Three copies in one buffer against one clean table (row b mod n):
    the same words, per-copy parity and summed counts as the reference's
    scrub of the concatenated copies and tables."""
    w, _, p = _case("clean", 11)
    copies = [w.copy() for _ in range(3)]
    _flip(copies[0], 3, 4)
    _flip(copies[1], 2 * BLOCK + 1, 31)
    _flip(copies[1], 2 * BLOCK + 9, 2)           # uncorrectable in copy 1
    _flip(copies[2], 8 * BLOCK + 31, 17)
    want_w, want_p, want_c = (np.asarray(x) for x in j_scrub(
        jnp.asarray(np.concatenate(copies)),
        jnp.asarray(np.concatenate([p] * 3))))
    buf = _to_t(np.concatenate(copies))
    out_p = torch.empty((3 * p.shape[0], 3), dtype=torch.int32)
    _, got_p, counts = D.scrub(buf, _to_t(p), out_parity=out_p)
    np.testing.assert_array_equal(buf.numpy(), want_w.view(np.int32))
    np.testing.assert_array_equal(got_p.numpy(), want_p.view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), want_c)
    # parity corrections may also be dropped: same words and counts
    buf2 = _to_t(np.concatenate(copies))
    _, none_p, counts2 = D.scrub(buf2, _to_t(p))
    assert none_p is None and torch.equal(buf2, buf)
    assert torch.equal(counts2, counts)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(kind):
    dev = _cuda()
    _, bad, p = _case(kind, KINDS.index(kind))
    want_w, want_p, want_c = D.scrub_ref(_to_t(bad), _to_t(p))
    par_t = _to_t(p).to(dev)
    assert torch.equal(D.encode_parity(_to_t(bad).to(dev)).cpu(),
                       D.encode_parity_ref(_to_t(bad)))
    buf = _to_t(bad).to(dev)
    _, got_p, counts = D.scrub(buf, par_t)
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), want_w)
    assert torch.equal(got_p.cpu(), want_p)
    assert torch.equal(counts.cpu(), want_c)


# Edge cases of the thread-per-block scrub: a warp tile is 32 blocks, so
# block counts that are not a multiple of 32 leave a tail; 2 to 8 parity
# families with negative slopes; one table shared by three stacked copies;
# corrected parity written for every row, healed in place, or dropped.
# Each block carries one of: a single data-bit error, a single parity-word
# error, two data-bit errors, every bit flipped, or nothing.
EDGE_CODES = [(1, (1, 2, -1)), (33, (1, 2)), (45, (1, 2, -1)),
              (77, (2, 1, -3, 5)), (100, (1, 2, -1, 3, -5, 7, -9, 11))]
EDGE_LAYOUTS = ["in_place", "out_all", "shared3_out", "shared3_dropped"]


def _plant_data(w, n, rs, shift=0):
    """Corrupt data words of block b by kind (b + shift) % 5."""
    for b in range(n):
        kind = (b + shift) % 5
        if kind == 0:
            _flip(w, b * BLOCK + rs.randint(BLOCK), rs.randint(32))
        elif kind == 2:
            i1, i2 = rs.choice(BLOCK, 2, replace=False)
            _flip(w, b * BLOCK + i1, rs.randint(32))
            _flip(w, b * BLOCK + i2, rs.randint(32))
        elif kind == 3:
            w[b * BLOCK:(b + 1) * BLOCK] ^= np.uint32(0xFFFFFFFF)


def _plant_parity(p, n, rs):
    for b in range(1, n, 5):          # kind 1: one parity-word error
        p[b, rs.randint(p.shape[1])] ^= np.uint32(1 << rs.randint(32))


def edge_case(n_blocks, slopes, layout, seed=0):
    """(words, table, out table or None, JAX words, JAX parity, JAX counts)
    of one edge case, the JAX side from the reference's `scrub_ref` over
    the concatenated copies and tables; numpy uint32."""
    rs = np.random.RandomState(seed + n_blocks)
    w = _words(n_blocks, seed + n_blocks)
    p = D.encode_parity_ref(_to_t(w), slopes).numpy().view(np.uint32).copy()
    copies = 3 if layout.startswith("shared3") else 1
    bufs = []
    for c in range(copies):
        wc = w.copy()
        _plant_data(wc, n_blocks, rs, shift=c)
        bufs.append(wc)
    _plant_parity(p, n_blocks, rs)
    words = np.concatenate(bufs)
    full = np.concatenate([p] * copies)
    want = [np.asarray(x) for x in j_scrub(jnp.asarray(words),
                                           jnp.asarray(full), slopes=slopes)]
    out = None
    if layout != "in_place" and layout != "shared3_dropped":
        out = np.zeros_like(full)
    return (words, p, out, *want)


def _run_edge(words, p, out, slopes, dev):
    buf, par = _to_t(words).to(dev), _to_t(p).to(dev)
    out_t = None if out is None else _to_t(out).to(dev)
    _, got_p, counts = D.scrub(buf, par, slopes, out_parity=out_t)
    return buf, par, got_p, counts


def _check_edge(layout, res, want_w, want_p, want_c):
    buf, par, got_p, counts = (None if x is None else x.cpu() for x in res)
    np.testing.assert_array_equal(buf.numpy(), want_w.view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), want_c)
    if layout == "shared3_dropped":
        assert got_p is None
    else:
        np.testing.assert_array_equal(got_p.numpy(), want_p.view(np.int32))
    if layout == "in_place":
        assert got_p is not None and torch.equal(got_p, par)


@pytest.mark.parametrize("layout", EDGE_LAYOUTS)
@pytest.mark.parametrize("n_blocks,slopes", EDGE_CODES,
                         ids=[f"n{n}F{len(s)}" for n, s in EDGE_CODES])
def test_scrub_edge_cases_match_jax(n_blocks, slopes, layout):
    words, p, out, want_w, want_p, want_c = edge_case(n_blocks, slopes,
                                                      layout)
    res = _run_edge(words, p, out, slopes, torch.device("cpu"))
    _check_edge(layout, res, want_w, want_p, want_c)
    if n_blocks >= 5:                 # every kind of block was planted
        assert want_c[0] > 0 and want_c[2] > 0
        assert layout.startswith("shared3") or want_c[1] > 0


@pytest.mark.parametrize("F", range(1, 9))
def test_encode_with_negative_slopes_matches_jax(F):
    slopes = (1, 2, -1, 3, -5, 7, -9, 11)[:F][::-1]
    w = _words(45, F)
    want = np.asarray(j_encode(jnp.asarray(w), slopes=slopes))
    got = D.encode_parity(_to_t(w), slopes)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def _plain_edge(words, p, out, slopes):
    """The plain version's result, as numpy, for the card cases."""
    buf, par, got_p, counts = _run_edge(words, p, out, slopes,
                                        torch.device("cpu"))
    return (buf.numpy().view(np.uint32), None if got_p is None else
            got_p.numpy().view(np.uint32), counts.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", EDGE_LAYOUTS)
@pytest.mark.parametrize("n_blocks,slopes", EDGE_CODES,
                         ids=[f"n{n}F{len(s)}" for n, s in EDGE_CODES])
def test_kernel_edge_cases_match_plain_on_card(n_blocks, slopes, layout):
    dev = _cuda()
    rs = np.random.RandomState(n_blocks)
    w = _words(n_blocks, n_blocks)
    p = D.encode_parity_ref(_to_t(w), slopes).numpy().view(np.uint32).copy()
    copies = 3 if layout.startswith("shared3") else 1
    bufs = [w.copy() for _ in range(copies)]
    for c, wc in enumerate(bufs):
        _plant_data(wc, n_blocks, rs, shift=c)
    _plant_parity(p, n_blocks, rs)
    words = np.concatenate(bufs)
    out = None if layout in ("in_place", "shared3_dropped") else \
        np.zeros((copies * n_blocks, len(slopes)), np.uint32)
    want_w, want_p, want_c = _plain_edge(words, p.copy(), out, slopes)
    res = _run_edge(words, p.copy(), out, slopes, dev)
    torch.cuda.synchronize()
    _check_edge(layout, res, want_w, want_p, want_c)


@pytest.mark.gpu
def test_kernel_rejects_misaligned_buffer_on_card():
    dev = _cuda()
    words = _to_t(_words(3, 5)).to(dev)
    par = D.encode_parity(words[:64])
    with pytest.raises(ValueError):
        D.scrub(words[1:65], par)       # 4 bytes past the allocation's start


# The CUDA encode's arithmetic (csrc/diag_parity.cu, `block_parity` in
# csrc/diag_scrub.cuh), emulated in numpy over all blocks at once: thread t
# of a 32-block tile holds its block as a[i] = w_((i + r) mod 32), r = 4t
# mod 32 (eight 16-byte reads, chunk c from chunk (c + t) mod 8), builds
# Y = XOR_i rotl32(a[i], s*i) by Horner's rule from i = 31 down, and writes
# rotl32(Y, s*r).

def _rotl(x, r):
    x = np.asarray(x, dtype=np.uint64)
    r = np.asarray(r, dtype=np.int64) % 32
    out = (x << r.astype(np.uint64)) | (x >> ((32 - r) % 32).astype(np.uint64))
    return (out & 0xFFFFFFFF).astype(np.uint32)


def emulate_horner_encode(w, slopes):
    n = w.size // BLOCK
    t = np.arange(n) % BLOCK
    i = np.arange(BLOCK)
    idx = 4 * ((i[None, :] // 4 + t[:, None]) % 8) + i[None, :] % 4
    a = w.reshape(n, BLOCK)[np.arange(n)[:, None], idx]
    r = (4 * t) % BLOCK
    out = np.zeros((n, len(slopes)), np.uint32)
    for f, s in enumerate(slopes):
        acc = np.zeros(n, np.uint32)
        for k in range(BLOCK - 1, -1, -1):
            acc = _rotl(acc, s) ^ a[:, k]
        out[:, f] = _rotl(acc, s * r)
    return out


@pytest.mark.parametrize("n_blocks", [1, 33, 77])
@pytest.mark.parametrize("F", range(1, 9))
def test_horner_encode_emulation_matches_jax(F, n_blocks):
    slopes = (1, 2, -1, 3, -5, 7, -9, 11)[:F][::-1]
    w = _words(n_blocks, 100 * F + n_blocks)
    want = np.asarray(j_encode(jnp.asarray(w), slopes=slopes))
    np.testing.assert_array_equal(emulate_horner_encode(w, slopes), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks", [1, 33, 45, 77, 100])
@pytest.mark.parametrize("F", range(1, 9))
def test_kernel_encode_edge_cases_match_plain_on_card(F, n_blocks):
    dev = _cuda()
    slopes = (1, 2, -1, 3, -5, 7, -9, 11)[:F][::-1]
    w = _to_t(_words(n_blocks, 100 * F + n_blocks))
    got = D.encode_parity(w.to(dev), slopes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), D.encode_parity_ref(w, slopes))


@pytest.mark.gpu
def test_kernel_encode_page_refresh_shape_on_card():
    """A server tick's parity refresh: 16 page rows of the full-width
    phi3-mini pool, 12,582,912 words."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(7)
    w = torch.randint(-2**31, 2**31, (12582912,), dtype=torch.int64,
                      device=dev, generator=g).to(torch.int32)
    got = D.encode_parity(w)
    assert torch.equal(got, D.encode_parity_ref(w))


@pytest.mark.gpu
def test_kernel_encode_rejects_misaligned_buffer_on_card():
    dev = _cuda()
    words = _to_t(_words(3, 5)).to(dev)
    with pytest.raises(RuntimeError):
        D.encode_parity(words[1:65])    # 4 bytes past the allocation's start
