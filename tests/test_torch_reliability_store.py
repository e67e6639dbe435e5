"""The port's `ReliableStore`, per-leaf path, `tmr_serve` and `Tmr.wrap`
(repro_torch.core.reliability, reliability.scheme) against the JAX
package's under the same numpy flips: stored words, parity, corrected
words and `ScrubReport`s identical (exact), for fp32, odd-length bf16 and
int32 leaves.  The kernel route on the card runs there only."""
import numpy as np
import pytest
import torch

from repro_torch.core import arena
from repro_torch.core import reliability as TR
from repro_torch.reliability import scheme as TS

try:    # without JAX (as on a GPU machine) only the JAX-free cases run
    import jax
    import jax.numpy as jnp
    from repro.core import reliability as JR
    from repro.reliability import scheme as JS
except ImportError:
    jnp = None

needs_jax = pytest.mark.skipif(jnp is None, reason="needs the JAX package")

#: leaf name -> (shape, raw bit dtype, value dtype)
LEAVES = {"a": ((65, 7), np.uint32, "float32"),
          "b": ((129,), np.uint16, "bfloat16"),
          "c": ((40,), np.uint32, "int32")}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "int32": torch.int32}
_TI = {np.uint32: torch.int32, np.uint16: torch.int16}


def _raw_leaves(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, u, _) in LEAVES.items():
        x = rng.standard_normal(shape).astype(np.float32)
        if u == np.uint16:          # bf16 values: the top halves of fp32
            out[k] = (x.view(np.uint32) >> 16).astype(np.uint16)
        elif k == "c":
            out[k] = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(
                np.uint32)
        else:
            out[k] = x.view(np.uint32)
    return out


def _to_torch(raw):
    return {k: torch.from_numpy(v.view(np.int32 if v.dtype == np.uint32
                                       else np.int16).copy()).view(
        _T[LEAVES[k][2]]) for k, v in raw.items()}


def _to_jax(raw):
    return {k: jax.lax.bitcast_convert_type(jnp.asarray(v),
                                            getattr(jnp, LEAVES[k][2]))
            for k, v in raw.items()}


def _raw_t(x):
    bits = torch.int16 if x.element_size() == 2 else torch.int32
    return x.contiguous().view(bits).numpy().view(
        np.uint16 if bits == torch.int16 else np.uint32)


def _raw_j(x):
    u = jnp.uint16 if x.dtype == jnp.bfloat16 else jnp.uint32
    return np.asarray(jax.lax.bitcast_convert_type(x, u))


def _masks(seed):
    """XOR masks over each leaf's raw bits: scattered single flips, a
    double in one block of `a` (uncorrectable) and one in `b`."""
    rng = np.random.default_rng(seed + 1000)
    masks = {}
    for k, (shape, u, _) in LEAVES.items():
        m = np.zeros(int(np.prod(shape)), u)
        width = 8 * m.itemsize
        idx = rng.choice(m.size, 4, replace=False)
        m[idx] ^= (np.ones(4, u) << rng.integers(0, width, 4).astype(u))
        masks[k] = m.reshape(shape)
    masks["a"].reshape(-1)[[300, 301]] ^= np.array([1 << 3, 1 << 30],
                                                   np.uint32)
    masks["b"][[5, 6]] ^= np.array([1 << 2, 1 << 9], np.uint16)
    return masks


def _report(rep):
    return [int(v) for v in rep]


@needs_jax
@pytest.mark.parametrize("backends", [("kernel", "kernel"), ("torch", "jnp")])
@pytest.mark.parametrize("seed", [0, 1])
def test_store_matches_jax_under_the_same_flips(backends, seed):
    tb, jb = backends
    raw, masks = _raw_leaves(seed), _masks(seed)
    jstore = JR.ReliableStore.protect(_to_jax(raw), backend=jb)
    tstore = TR.ReliableStore.protect(_to_torch(raw), backend=tb)
    jpar = np.asarray(jstore.parity)
    np.testing.assert_array_equal(tstore.parity.numpy().view(np.uint32), jpar)
    assert tstore.n_blocks == jstore.n_blocks
    bad = {k: raw[k] ^ masks[k] for k in raw}
    # a check word flipped too, in the first block no data flip reached
    clean_w, _ = arena.pack(_to_torch(raw))
    bad_w, _ = arena.pack(_to_torch(bad))
    hit = (clean_w != bad_w).view(-1, 32).any(1)
    pflip = np.zeros_like(jpar)
    pflip[int(torch.nonzero(~hit)[0]), 2] = np.uint32(1 << 17)
    jfixed, jrep = JR.ReliableStore(_to_jax(bad), jnp.asarray(jpar ^ pflip),
                                    backend=jb).scrub()
    for k, x in tstore.params.items():              # in place, the views
        x.view(_TI[LEAVES[k][1]]).view(-1).__ixor__(
            torch.from_numpy(masks[k].reshape(-1).view(
                np.int32 if masks[k].dtype == np.uint32 else np.int16)))
    tstore.parity ^= torch.from_numpy(pflip.view(np.int32))
    tfixed, trep = tstore.scrub()
    assert _report(trep) == _report(jrep)
    assert all(v.dtype == torch.int32 for v in trep)
    assert _report(trep)[2] >= 1 and _report(trep)[1] == 1
    for k in raw:
        np.testing.assert_array_equal(_raw_t(tfixed.params[k]),
                                      _raw_j(jfixed.params[k]), err_msg=k)
    np.testing.assert_array_equal(tfixed.parity.numpy().view(np.uint32),
                                  np.asarray(jfixed.parity))
    # in place: the store's own views hold the corrected bits
    assert tfixed.params["a"].data_ptr() == tstore.params["a"].data_ptr()


@needs_jax
def test_store_from_plain_tensors_matches_jax():
    """ReliableStore(params, parity) over tensors that are not arena views
    scrubs a packed copy (adopt); the given tensors are left as they are."""
    raw, masks = _raw_leaves(3), _masks(3)
    parity = TR.ReliableStore.protect(_to_torch(raw)).parity
    bad = {k: raw[k] ^ masks[k] for k in raw}
    tb = _to_torch(bad)
    before = {k: _raw_t(v).copy() for k, v in tb.items()}
    tfixed, trep = TR.ReliableStore(tb, parity.clone()).scrub()
    jfixed, jrep = JR.ReliableStore(
        _to_jax(bad), jnp.asarray(parity.numpy().view(np.uint32))).scrub()
    assert _report(trep) == _report(jrep)
    for k in raw:
        np.testing.assert_array_equal(_raw_t(tfixed.params[k]),
                                      _raw_j(jfixed.params[k]))
        np.testing.assert_array_equal(_raw_t(tb[k]), before[k])


def test_store_refresh_and_backend_check():
    raw = _raw_leaves(4)
    store = TR.ReliableStore.protect(_to_torch(raw))
    new = _to_torch(_raw_leaves(5))
    fresh = store.refresh(new)
    assert torch.equal(fresh.parity,
                       TR.ReliableStore.protect(new, backend="torch").parity)
    _, rep = fresh.scrub()
    assert _report(rep) == [0, 0, 0]
    with pytest.raises(ValueError):
        TR.ReliableStore.protect(new, backend="jnp")


@needs_jax
@pytest.mark.parametrize("seed", [0, 7])
def test_per_leaf_path_matches_jax(seed):
    raw, masks = _raw_leaves(seed), _masks(seed)
    tpt = TR.protect_leaves(_to_torch(raw))
    jpt = JR.protect_leaves(_to_jax(raw))
    for k in raw:
        np.testing.assert_array_equal(tpt[k].numpy().view(np.uint32),
                                      np.asarray(jpt[k]))
    bad = {k: raw[k] ^ masks[k] for k in raw}
    tf, tp, trep = TR.scrub_leaves(_to_torch(bad), tpt)
    jf, jp, jrep = JR.scrub_leaves(_to_jax(bad), jpt)
    assert _report(trep) == _report(jrep)
    for k in raw:
        np.testing.assert_array_equal(_raw_t(tf[k]), _raw_j(jf[k]))
        np.testing.assert_array_equal(tp[k].numpy().view(np.uint32),
                                      np.asarray(jp[k]))
    # the arena path corrects the same blocks
    store = TR.ReliableStore.protect(_to_torch(raw))
    fixed, rep = TR.ReliableStore(_to_torch(bad), store.parity).scrub()
    assert _report(rep)[0] == _report(trep)[0]
    assert _report(rep)[2] == _report(trep)[2]


def _serve(params, x):
    return {"y": params["a"] * x, "n": params["c"] + 1, "h": params["b"]}


def _copies(seed):
    """Three copies of one tree, each with its own flips (so most bits
    have a majority and a few words three-way disagree)."""
    raw = _raw_leaves(seed)
    return [{k: v ^ _masks(seed + 10 * i)[k] for k, v in raw.items()}
            for i in range(3)]


@needs_jax
@pytest.mark.parametrize("mode", ["serial", "parallel", "semi_parallel"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_tmr_serve_votes_as_jax(mode, use_kernel):
    copies = _copies(2)
    got = TR.tmr_serve(_serve, mode, use_kernel)(
        *[_to_torch(c) for c in copies], torch.tensor(2.0))
    want = JR.tmr_serve(_serve, mode, use_kernel)(
        *[_to_jax(c) for c in copies], jnp.float32(2.0))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(_raw_t(got[k]), _raw_j(want[k]))


@needs_jax
@pytest.mark.parametrize("discipline", ["serial", "parallel",
                                        "semi_parallel"])
def test_tmr_wrap_matches_jax(discipline):
    copies = _copies(6)
    for seq in (False, True):
        tw = TS.Tmr(discipline).wrap(_serve, sequential=seq)
        jw = JS.Tmr(discipline).wrap(_serve, sequential=seq)
        got = tw(*[_to_torch(c) for c in copies], torch.tensor(2.0))
        want = jw(*[_to_jax(c) for c in copies], jnp.float32(2.0))
        for k in got:
            np.testing.assert_array_equal(_raw_t(got[k]), _raw_j(want[k]))
        assert tw.cost == TS.Tmr(discipline).overhead()
        assert (tw.cost.storage_x, tw.cost.latency_x, tw.cost.area_x,
                tw.cost.throughput_x) == (jw.cost.storage_x,
                                          jw.cost.latency_x, jw.cost.area_x,
                                          jw.cost.throughput_x)


@pytest.mark.parametrize("spec", ["off", "ecc", "tmr-serial", "ecc+tmr"])
def test_adopt_rebuilds_the_same_store(spec):
    """adopt(payload, redundancy) of a corrupted store scrubs and reads as
    the store itself does."""
    from repro_torch.faults import TransientBitFlips
    scheme = TS.parse_scheme(spec)
    tree = _to_torch(_raw_leaves(8))
    outs = []
    for adopt in (False, True):
        prot = scheme.protect(tree)
        scheme.corrupt_store(prot, TransientBitFlips(2e-3),
                             torch.Generator().manual_seed(1))
        if adopt:
            prot = scheme.adopt(prot.payload, prot.redundancy)
        prot, rep = scheme.scrub(prot)
        outs.append((_report(rep), {k: _raw_t(v).copy() for k, v in
                                    scheme.read(prot).items()}))
    (r0, p0), (r1, p1) = outs
    assert r0 == r1
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_store_kernel_matches_torch_backend_on_card():
    dev = _cuda()
    from repro_torch import kernels
    raw, masks = _raw_leaves(9), _masks(9)
    tree = {k: v.to(dev) for k, v in _to_torch(raw).items()}
    out = []
    for backend in ("kernel", "torch"):
        store = TR.ReliableStore.protect(tree, backend=backend)
        for k, x in store.params.items():
            x.view(_TI[LEAVES[k][1]]).view(-1).__ixor__(torch.from_numpy(
                masks[k].reshape(-1).view(np.int32 if masks[k].dtype ==
                                          np.uint32 else np.int16)).to(dev))
        kernels.reset_launch_counts()
        fixed, rep = store.scrub()
        launched = kernels.launch_counts().get("scrub", 0)
        assert launched == (1 if backend == "kernel" else 0)
        out.append((_report(rep), fixed.parity.cpu(),
                    {k: _raw_t(v.cpu()) for k, v in fixed.params.items()}))
    (r0, p0, w0), (r1, p1, w1) = out
    assert r0 == r1 and torch.equal(p0, p1)
    assert all(np.array_equal(w0[k], w1[k]) for k in w0)
