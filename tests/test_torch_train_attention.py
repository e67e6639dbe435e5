"""The port's `blocked_attention` with its recompute backward against the
JAX package's (`blocked_attention_core` and its custom VJP): the forward
and the q/k/v grads of ``(out * ct).sum()`` for a random cotangent match
``jax.grad`` of the reference's within rtol 1e-4 (atol 1e-4 of the
largest reference value) over `tests/test_attention.py`'s cases; the
forward with grad equals the forward without grad bit for bit (the serve
path's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blocked_attention as j_blocked
from repro_torch.models.attention import blocked_attention, naive_attention

CASES = [
    dict(B=2, Sq=64, Sk=64, H=4, KV=2, hd=16, causal=True, window=0),
    dict(B=1, Sq=128, Sk=128, H=8, KV=8, hd=8, causal=True, window=0),
    dict(B=2, Sq=64, Sk=64, H=4, KV=1, hd=16, causal=True, window=24),
    dict(B=2, Sq=32, Sk=32, H=4, KV=4, hd=8, causal=False, window=0),
    dict(B=1, Sq=48, Sk=48, H=2, KV=2, hd=32, causal=True, window=0),
]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((c["B"], c["Sq"], c["H"], c["hd"]), np.float32)
    k = rng.standard_normal((c["B"], c["Sk"], c["KV"], c["hd"]), np.float32)
    v = rng.standard_normal((c["B"], c["Sk"], c["KV"], c["hd"]), np.float32)
    dout = rng.standard_normal(q.shape, np.float32)
    return q, k, v, dout


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"S{c['Sq']}kv{c['KV']}w{c['window']}")
def test_forward_and_grads_match_reference(case):
    c = dict(case)
    causal, window = c.pop("causal"), c.pop("window")
    q, k, v, ct = _inputs(case)
    kw = dict(causal=causal, window=window, q_block=16, kv_block=16)

    @jax.jit
    def jf(q, k, v):
        out, vjp = jax.vjp(lambda q, k, v: j_blocked(q, k, v, **kw), q, k, v)
        return out, vjp(jnp.asarray(ct))

    jout, jg = jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = blocked_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out.detach().numpy(), jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got.numpy(), want)
    with torch.no_grad():
        plain = blocked_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  **kw)
    assert torch.equal(plain, out.detach())


@pytest.mark.parametrize("case", CASES[:3],
                         ids=lambda c: f"S{c['Sq']}kv{c['KV']}w{c['window']}")
def test_grads_match_naive_oracle(case):
    """The recompute backward against autograd through the full-matrix
    attention (the port's own oracle, as the reference tests its)."""
    c = dict(case)
    causal, window = c.pop("causal"), c.pop("window")
    q, k, v, _ = _inputs(case, seed=1)
    grads = []
    for fn, kw in ((blocked_attention, dict(q_block=16, kv_block=16)),
                   (naive_attention, {})):
        t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        fn(*t, causal=causal, window=window, **kw).sum().backward()
        grads.append([x.grad.numpy() for x in t])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_block_sizes_do_not_change_grads():
    q, k, v, _ = _inputs(dict(B=1, Sq=64, Sk=64, H=4, KV=2, hd=16))
    grads = []
    for bq, bk in [(8, 8), (16, 32), (64, 64)]:
        t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        blocked_attention(*t, q_block=bq, kv_block=bk).sum().backward()
        grads.append([x.grad.numpy() for x in t])
    for g in grads[1:]:
        for a, b in zip(grads[0], g):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_bf16_inputs_give_bf16_grads():
    q, k, v, _ = _inputs(dict(B=1, Sq=32, Sk=32, H=2, KV=2, hd=16))
    t = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
         for x in (q, k, v)]
    out = blocked_attention(*t, q_block=16, kv_block=16)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16
    assert all(x.grad.dtype == torch.bfloat16 for x in t)
