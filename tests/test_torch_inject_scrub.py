"""The fused inject+scrub of the port (repro_torch.kernels.inject_scrub,
whose wrapper takes the plain version for a CPU tensor) against the JAX
package's Pallas kernel (interpret mode) and its `inject_scrub_ref`, bit
for bit -- words, parity and the (4,) counts injected / corrected /
parity_fixed / uncorrectable -- on zero, single-flip, multi-flip and random
masks; a zero mask equals the plain diagonal-parity scrub; the scheme
routing; plus the CUDA kernel against the plain version on the card
(skipped without one)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import diag_parity as D
from repro_torch.kernels.inject_scrub import inject_scrub, inject_scrub_ref
from repro_torch.reliability import parse_scheme

try:    # without JAX (as on a GPU machine) only the kernel cases run
    import jax.numpy as jnp
    from repro.kernels.inject_scrub import inject_scrub as j_inject
    from repro.kernels.inject_scrub import inject_scrub_ref as j_ref
except ImportError:
    jnp = None

BLOCK = 32
N_BLOCKS = 12


def _words(n_blocks, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2**32, size=n_blocks * BLOCK,
                      dtype=np.uint64).astype(np.uint32)


def _to_t(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.view(np.int32).copy())


def _mask(kind, seed):
    rs = np.random.RandomState(seed)
    m = np.zeros(N_BLOCKS * BLOCK, np.uint32)
    if kind == "single":            # one flip in each of four blocks
        for b in (0, 3, 7, 11):
            m[b * BLOCK + rs.randint(BLOCK)] = np.uint32(1 << rs.randint(32))
    elif kind == "multi":           # 2 and 3 flips per block, some blocks
        m[2 * BLOCK + 1] = np.uint32((1 << 4) | (1 << 9))
        m[5 * BLOCK + 0] = np.uint32(1 << 31)
        m[5 * BLOCK + 30] = np.uint32(1 << 0)
        m[9 * BLOCK + 3] = np.uint32(1 << 17)
        m[9 * BLOCK + 4] = np.uint32(1 << 17)
        m[9 * BLOCK + 5] = np.uint32(1 << 17)
        m[10 * BLOCK + 6] = np.uint32(1 << 2)      # plus a correctable one
    elif kind == "random":
        m = (rs.random_sample((m.size, 32)) < 0.004).astype(np.uint64)
        m = (m << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return m


KINDS = ["zero", "single", "multi", "random"]


@pytest.mark.parametrize("slopes", [(1, 2, -1), (1, 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_inject_scrub_matches_jax(kind, slopes):
    seed = KINDS.index(kind)
    w = _words(N_BLOCKS, seed)
    m = _mask(kind, seed)
    p = D.encode_parity_ref(_to_t(w), slopes).numpy().view(np.uint32)
    jw, jp, jc = (np.asarray(x) for x in j_inject(
        jnp.asarray(w), jnp.asarray(p), jnp.asarray(m), slopes=slopes,
        interpret=True))
    rw, rp, rc = (np.asarray(x) for x in j_ref(
        jnp.asarray(w), jnp.asarray(p), jnp.asarray(m), slopes=slopes))
    np.testing.assert_array_equal(jw, rw)            # the two JAX paths
    np.testing.assert_array_equal(jc, rc)
    buf, par = _to_t(w), _to_t(p)
    out, out_p, counts = inject_scrub(buf, par, _to_t(m), slopes)
    assert out is buf and out_p is par               # in place
    assert counts.shape == (4,) and counts.dtype == torch.int32
    np.testing.assert_array_equal(buf.numpy(), jw.view(np.int32))
    np.testing.assert_array_equal(par.numpy(), jp.view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), jc)
    if kind == "single":
        assert counts.tolist() == [4, 4, 0, 0]
    if kind == "multi":
        assert counts.tolist()[0] == 8 and counts.tolist()[1] >= 1
        assert counts.tolist()[3] >= 2


def test_zero_mask_equals_plain_scrub():
    w = _words(N_BLOCKS, 9)
    p = D.encode_parity_ref(_to_t(w))
    bad = w.copy()
    bad[4 * BLOCK + 2] ^= np.uint32(1 << 5)
    p[6, 1] ^= 1 << 3
    a, pa = _to_t(bad), p.clone()
    b, pb = _to_t(bad), p.clone()
    _, _, ca = inject_scrub(a, pa, torch.zeros_like(a))
    _, _, cb = D.scrub(b, pb)
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert ca.tolist() == [0] + cb.tolist()


def test_diag_scheme_routes_to_fused_op():
    """`DiagParityEcc.inject_scrub_arena` is the fused op; Hsiao takes the
    default XOR-then-scrub (test_torch_hsiao.py)."""
    w = _words(N_BLOCKS, 4)
    m = _mask("single", 4)
    ecc = parse_scheme("ecc")
    buf = _to_t(w)
    par = ecc.encode_arena(buf)
    want = inject_scrub_ref(_to_t(w), par.clone(), _to_t(m))
    _, par2, counts = ecc.inject_scrub_arena(buf, par, _to_t(m))
    assert torch.equal(buf, want[0]) and torch.equal(par2, want[1])
    assert torch.equal(counts, want[2])
    assert torch.equal(buf, _to_t(w))                 # every flip repaired


def test_rejects_bad_mask():
    buf = _to_t(_words(2, 0))
    par = D.encode_parity_ref(buf)
    with pytest.raises(ValueError):
        inject_scrub(buf, par, torch.zeros(32, dtype=torch.int32))
    with pytest.raises(ValueError):
        inject_scrub(buf, par, torch.zeros(64, dtype=torch.int64))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(kind):
    dev = _cuda()
    seed = KINDS.index(kind)
    w, m = _words(N_BLOCKS, seed), _mask(kind, seed)
    p = D.encode_parity_ref(_to_t(w))
    want_w, want_p, want_c = inject_scrub_ref(_to_t(w), p.clone(), _to_t(m))
    buf, par = _to_t(w).to(dev), p.to(dev)
    _, got_p, counts = inject_scrub(buf, par, _to_t(m).to(dev))
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), want_w)
    assert torch.equal(got_p.cpu(), want_p)
    assert torch.equal(counts.cpu(), want_c)


@pytest.mark.gpu
def test_kernel_zero_mask_equals_scrub_kernel_on_card():
    dev = _cuda()
    w = _words(5001, 3)
    p = D.encode_parity_ref(_to_t(w))
    rs = np.random.RandomState(3)
    for i in rs.choice(w.size, 900, replace=False):
        w[i] ^= np.uint32(1 << rs.randint(32))
    a, b = _to_t(w).to(dev), _to_t(w).to(dev)
    pa, pb = p.to(dev), p.to(dev)
    _, _, ca = inject_scrub(a, pa, torch.zeros_like(a))
    _, _, cb = D.scrub(b, pb)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert ca.cpu().tolist() == [0] + cb.cpu().tolist()


# Edge cases of the thread-per-block scrub body with the mask folded in:
# tails past a 32-block warp tile, 2 to 8 families with negative slopes, a
# table shared by three stacked copies, parity written for every row or
# healed in place, and masks that overlap a correction.  Each block gets
# by kind (b % 6): one injected data-bit flip (the correction undoes it,
# so no word is written), one parity-word flip, two flips, every bit
# flipped, a flip that cancels an error already in the words, or that
# cancelling flip plus one more, which the correction undoes.
EDGE_CODES = [(1, (1, 2, -1)), (33, (1, 2)), (45, (1, 2, -1)),
              (77, (2, 1, -3, 5)), (100, (1, 2, -1, 3, -5, 7, -9, 11))]
EDGE_LAYOUTS = ["in_place", "out_all", "shared3_out"]


def edge_inputs(n_blocks, slopes, layout):
    """(words, mask, table, out table or None) as numpy uint32."""
    rs = np.random.RandomState(n_blocks)
    w = _words(n_blocks, n_blocks + 50)
    p = D.encode_parity_ref(_to_t(w), slopes).numpy().view(np.uint32).copy()
    copies = 3 if layout.startswith("shared3") else 1
    words = np.concatenate([w] * copies)
    mask = np.zeros_like(words)
    for c in range(copies):
        for b in range(n_blocks):
            base = (c * n_blocks + b) * BLOCK
            i, bit = rs.randint(BLOCK), np.uint32(1 << rs.randint(32))
            kind = (b + c) % 6
            if kind == 0:
                mask[base + i] ^= bit
            elif kind == 1 and c == 0:
                p[b, rs.randint(len(slopes))] ^= bit
            elif kind == 2:
                i2 = (i + 1 + rs.randint(BLOCK - 1)) % BLOCK
                mask[base + i] ^= bit
                mask[base + i2] ^= np.uint32(1 << rs.randint(32))
            elif kind == 3:
                mask[base:base + BLOCK] = np.uint32(0xFFFFFFFF)
            elif kind == 4:               # the mask undoes a stored error
                words[base + i] ^= bit
                mask[base + i] ^= bit
            elif kind == 5:               # and flips one more, corrected
                words[base + i] ^= bit
                mask[base + i] ^= bit
                mask[base + (i + 7) % BLOCK] ^= np.uint32(
                    1 << rs.randint(32))
    out = None if layout == "in_place" else np.zeros(
        (copies * n_blocks, len(slopes)), np.uint32)
    return words, mask, p, out


def _run_edge(words, mask, p, out, slopes, dev):
    buf, par = _to_t(words).to(dev), _to_t(p).to(dev)
    out_t = None if out is None else _to_t(out).to(dev)
    _, got_p, counts = inject_scrub(buf, par, _to_t(mask).to(dev), slopes,
                                    out_parity=out_t)
    return buf.cpu(), got_p.cpu(), counts.cpu()


@pytest.mark.parametrize("layout", EDGE_LAYOUTS)
@pytest.mark.parametrize("n_blocks,slopes", EDGE_CODES,
                         ids=[f"n{n}F{len(s)}" for n, s in EDGE_CODES])
def test_inject_scrub_edge_cases_match_jax(n_blocks, slopes, layout):
    words, mask, p, out = edge_inputs(n_blocks, slopes, layout)
    copies = words.size // (n_blocks * BLOCK)
    jw, jp, jc = (np.asarray(x) for x in j_ref(
        jnp.asarray(words), jnp.asarray(np.concatenate([p] * copies)),
        jnp.asarray(mask), slopes=slopes))
    buf, got_p, counts = _run_edge(words, mask, p, out, slopes,
                                   torch.device("cpu"))
    np.testing.assert_array_equal(buf.numpy(), jw.view(np.int32))
    np.testing.assert_array_equal(got_p.numpy(), jp.view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), jc)
    if n_blocks >= 6:
        assert min(jc[0], jc[1], jc[3]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("layout", EDGE_LAYOUTS)
@pytest.mark.parametrize("n_blocks,slopes", EDGE_CODES,
                         ids=[f"n{n}F{len(s)}" for n, s in EDGE_CODES])
def test_kernel_edge_cases_match_plain_on_card(n_blocks, slopes, layout):
    dev = _cuda()
    words, mask, p, out = edge_inputs(n_blocks, slopes, layout)
    want = _run_edge(words, mask, p, out, slopes, torch.device("cpu"))
    got = _run_edge(words, mask, p, out, slopes, dev)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_kernel_rejects_misaligned_mask_on_card():
    dev = _cuda()
    buf = _to_t(_words(2, 5)).to(dev)
    par = D.encode_parity(buf)
    mask = torch.zeros(65, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        inject_scrub(buf, par, mask[1:])  # 4 bytes past the allocation
