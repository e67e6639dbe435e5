"""Attention: the port's flash-attention op (the plain version on a CPU
tensor), blocked and naive attention against the JAX package's
`flash_attention` (Pallas, interpret mode) and its jnp paths, for causal,
windowed and GQA shapes in float32 and bfloat16; plus the CUDA kernel
against the plain version on the card (skipped without one).

Tolerances: float32 2e-5 -- the same math summed in another order (torch
vs XLA CPU kernels, online vs full softmax); bfloat16 2e-2 -- both sides
compute in float32 and round the output to bfloat16, whose step near 1 is
2**-7, so an fp32 difference in the last bits can move the rounding by
one step."""
import numpy as np
import pytest
import torch

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
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(c, dtype, seed=0):
    """q (B,S,H,hd), k, v (B,S,KV,hd) as torch tensors of `dtype`."""
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randn(c["B"], c["S"], h, c["hd"])
                                  .astype(np.float32)).to(getattr(torch,
                                                                  dtype))
                 for h in (c["H"], c["KV"], c["KV"]))


def _jax(x):
    """The same values as a JAX array (bf16 -> f32 -> bf16 is exact)."""
    return jnp.asarray(x.float().numpy()).astype(getattr(jnp,
                                                         str(x.dtype)[6:]))


def _ids(c):
    return f"H{c['H']}kv{c['KV']}hd{c['hd']}w{c['window']}" \
        f"{'c' if c['causal'] else 'nc'}"


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
    dict(B=2, H=40, KV=8, S=300, hd=128, causal=True, window=128),
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
