"""Attention: the port's flash-attention op (the plain version on a CPU
tensor), blocked and naive attention against the JAX package's
`flash_attention` (Pallas, interpret mode) and its jnp paths, for causal,
windowed and GQA shapes, head_dim 256 (the hybrid's local attention past
its window) and non-causal cross-attention to a longer memory (Sk != Sq),
in float32 and bfloat16; plus the CUDA kernel against the plain version on
the card (skipped without one).

Tolerances: float32 2e-5 -- the same math summed in another order (torch
vs XLA CPU kernels, online vs full softmax); bfloat16 2e-2 -- both sides
compute in float32 and round the output to bfloat16, whose step near 1 is
2**-7, so an fp32 difference in the last bits can move the rounding by
one step.  The bfloat16 CUDA kernel also rounds P to bfloat16 before P.V
(tensor cores); a plain emulation of its arithmetic holds that inside the
same 2e-2 against the JAX kernel here, and the kernel against the
emulation on the card.  The same emulation shows that `chip_smoke`'s
phase-12 bf16 gate (`flash_bf16_tolerance`) passes that rounding and
fails a kv tile lost or added twice."""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models import attention as A

try:    # without JAX (as on a GPU machine) only the kernel cases run
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as j_flash
    from repro.models import attention as JA
except ImportError:
    jnp = None

CASES = [
    dict(B=1, H=4, KV=4, S=32, hd=16, causal=True, window=0),
    dict(B=2, H=4, KV=2, S=32, hd=24, causal=True, window=0),
    dict(B=1, H=4, KV=1, S=64, hd=16, causal=True, window=24),
    dict(B=1, H=2, KV=2, S=32, hd=16, causal=False, window=0),
    # the hybrid's local attention (head_dim 256, past its window) and
    # cross-attention to a longer memory (Sk != Sq, no mask)
    dict(B=1, H=2, KV=1, S=48, hd=256, causal=True, window=16),
    dict(B=2, H=4, KV=4, S=32, Sk=48, hd=64, causal=False, window=0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(c, dtype, seed=0):
    """q (B,S,H,hd), k, v (B,S,KV,hd) as torch tensors of `dtype`."""
    rs = np.random.RandomState(seed)
    Sk = c.get("Sk", c["S"])
    return tuple(torch.from_numpy(rs.randn(c["B"], n, h, c["hd"])
                                  .astype(np.float32)).to(getattr(torch,
                                                                  dtype))
                 for n, h in ((c["S"], c["H"]), (Sk, c["KV"]),
                              (Sk, c["KV"])))


def _jax(x):
    """The same values as a JAX array (bf16 -> f32 -> bf16 is exact)."""
    return jnp.asarray(x.float().numpy()).astype(getattr(jnp,
                                                         str(x.dtype)[6:]))


def _ids(c):
    return f"H{c['H']}kv{c['KV']}hd{c['hd']}w{c['window']}" \
        f"{'c' if c['causal'] else 'nc'}" \
        + (f"sk{c['Sk']}" if "Sk" in c else "")


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("c", CASES, ids=_ids)
def test_flash_op_matches_jax_kernel(c, dtype):
    q, k, v = _qkv(c, dtype)
    want = j_flash(_jax(q), _jax(k), _jax(v), causal=c["causal"],
                   window=c["window"], q_block=16, kv_block=16)
    got = flash_attention(q, k, v, causal=c["causal"], window=c["window"])
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("c", CASES, ids=_ids)
def test_blocked_and_naive_match_jax(c):
    q, k, v = _qkv(c, "float32", seed=1)
    kw = dict(causal=c["causal"], window=c["window"])
    jq, jk, jv = (_jax(x) for x in (q, k, v))
    want_b = JA.blocked_attention(jq, jk, jv, q_block=8, kv_block=16, **kw)
    got_b = A.blocked_attention(q, k, v, q_block=8, kv_block=16, **kw)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=TOL["float32"], atol=TOL["float32"])
    want_n = JA.naive_attention(jq, jk, jv, **kw)
    got_n = A.naive_attention(q, k, v, **kw)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n),
                               rtol=TOL["float32"], atol=TOL["float32"])


def test_flash_rejects_offset_queries():
    q, k, v = _qkv(CASES[0], "float32")
    with pytest.raises(ValueError):
        flash_attention(q, k, v, q_offset=4)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


GPU_CASES = CASES + [
    dict(B=4, H=32, KV=32, S=256, hd=96, causal=True, window=0),
    dict(B=1, H=32, KV=32, S=256, hd=96, causal=True, window=0),
    dict(B=2, H=40, KV=8, S=300, hd=128, causal=True, window=128),
    dict(B=2, H=10, KV=1, S=300, hd=256, causal=True, window=0),
    dict(B=1, H=10, KV=1, S=700, hd=256, causal=True, window=256),
    dict(B=1, H=32, KV=8, S=256, Sk=1600, hd=128, causal=False, window=0),
    dict(B=2, H=16, KV=16, S=200, Sk=264, hd=64, causal=False, window=0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("c", GPU_CASES, ids=_ids)
def test_kernel_matches_plain_on_card(c, dtype):
    dev = _cuda()
    q, k, v = (x.to(dev) for x in _qkv(c, dtype, seed=2))
    want = flash_attention_ref(q, k, v, causal=c["causal"],
                               window=c["window"])
    got = flash_attention(q, k, v, causal=c["causal"], window=c["window"])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def emulate_bf16_kernel(q, k, v, *, causal=True, window=0, bq=64, bk=64,
                        lose=None, twice=None):
    """The bfloat16 CUDA kernel's arithmetic in plain PyTorch: 64-row query
    tiles; for each, the kv tiles of `bk` keys it can see (tiles past the
    causal diagonal or before the window skipped); scores of the bf16
    inputs in fp32, scaled by log2(e)/sqrt(hd); the online softmax in fp32
    with exp2, -1e30 masks and the row sum of the fp32 P; P rounded to
    bf16 before P.V, fp32 accumulation; 1/max(l, 1e-30); bf16 output.
    `lose` / `twice`: a kv tile index the emulated kernel skips, or adds
    twice (faults a gate must catch)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qf, kf, vf = (x.float() for x in (q, k, v))
    kf = kf.repeat_interleave(H // KV, dim=2)
    vf = vf.repeat_interleave(H // KV, dim=2)
    scale = np.log2(np.e) / hd ** 0.5
    out = torch.empty(B, Sq, H, hd)
    for q0 in range(0, Sq, bq):
        qt = qf[:, q0:q0 + bq].transpose(1, 2)             # (B, H, r, hd)
        rows = torch.arange(q0, q0 + qt.shape[2])[:, None]
        m = torch.full(qt.shape[:3], -1e30)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        k_hi = min(Sk, q0 + bq) if causal else Sk
        k_lo = max(0, q0 - window + 1) // bk * bk if window else 0
        for k0 in range(k_lo, k_hi, bk):
            if k0 // bk == lose:
                continue
            kt = kf[:, k0:k0 + bk].transpose(1, 2)
            vt = vf[:, k0:k0 + bk].transpose(1, 2)
            x = (qt @ kt.transpose(-1, -2)) * scale
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            keep = torch.ones(rows.shape[0], cols.shape[1], dtype=torch.bool)
            if causal:
                keep &= rows >= cols
            if window:
                keep &= cols > rows - window
            x = torch.where(keep, x, torch.tensor(-1e30))
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - m_new[..., None])
            corr = torch.exp2(m - m_new)
            n = 2 if k0 // bk == twice else 1
            l = l * corr + n * p.sum(-1)
            acc = acc * corr[..., None] + \
                n * (p.to(torch.bfloat16).float() @ vt)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + bq] = o.transpose(1, 2)
    return out.to(torch.bfloat16)


EMU_CASES = CASES + [
    dict(B=1, H=2, KV=2, S=256, hd=96, causal=True, window=0),
    dict(B=1, H=4, KV=2, S=192, hd=128, causal=True, window=72),
]


@pytest.mark.parametrize("c", EMU_CASES, ids=_ids)
def test_bf16_kernel_numerics_match_jax_kernel(c):
    """P rounded to bf16 before P.V (the kernel's tensor-core product)
    stays inside the unchanged bf16 tolerance of the JAX kernel, which
    computes p @ v in fp32."""
    q, k, v = _qkv(c, "bfloat16", seed=3)
    blk = 64 if c["S"] % 64 == 0 else 16
    want = j_flash(_jax(q), _jax(k), _jax(v), causal=c["causal"],
                   window=c["window"], q_block=blk, kv_block=blk)
    got = emulate_bf16_kernel(q, k, v, causal=c["causal"],
                              window=c["window"])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("shape", chip_smoke.P12_FLASH, ids=lambda s: s[0])
def test_phase12_bf16_gate_holds_rounding_and_catches_a_lost_tile(shape):
    """`chip_smoke.flash_bf16_tolerance`, phase 12's bf16 gate, passes the
    kernel's emulated rounding with room (at most 0.75 of the bound) and
    fails when one kv tile (first, middle or last) is dropped or the
    middle one is added twice.  One batch row and at most two kv heads
    (the gate is per element); 3072 tokens under the 2048 window are cut
    to 768 under 512, still past the window."""
    what, _, Sq, Sk, H, KV, hd, causal, window = shape
    if Sq > 1024:
        Sq = Sk = 768
        window = 512
    c = dict(B=1, S=Sq, Sk=Sk, H=H // KV * min(KV, 2), KV=min(KV, 2),
             hd=hd, causal=causal, window=window)
    q, k, v = _qkv(c, "bfloat16", seed=5)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = chip_smoke.flash_bf16_tolerance(want)

    def share(**fault):
        got = emulate_bf16_kernel(q, k, v, causal=causal, window=window,
                                  **fault)
        return ((got.float() - want.float()).abs() / tol).nan_to_num(
            nan=np.inf).max().item()

    assert share() <= 0.75
    tiles = (Sk + 63) // 64
    for fault in (dict(lose=0), dict(lose=tiles // 2),
                  dict(lose=tiles - 1), dict(twice=tiles // 2)):
        assert share(**fault) > 1, fault


@pytest.mark.gpu
@pytest.mark.parametrize("c", GPU_CASES, ids=_ids)
def test_bf16_kernel_matches_its_emulation_on_card(c):
    dev = _cuda()
    q, k, v = _qkv(c, "bfloat16", seed=4)
    want = emulate_bf16_kernel(q, k, v, causal=c["causal"],
                               window=c["window"])
    got = flash_attention(*(x.to(dev) for x in (q, k, v)),
                          causal=c["causal"], window=c["window"])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
