"""Per-bit 2-of-3 vote: the port's op (the plain version on a CPU tensor)
against the JAX package's `tmr_vote.ops.vote` (Pallas, interpret mode),
bit for bit for int32, float32 and bfloat16; plus the CUDA kernel against
the plain version on the card (skipped without one)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.tmr_vote import vote, vote_ref

try:    # without JAX (as on a GPU machine) only the kernel cases run
    import jax
    import jax.numpy as jnp
    from repro.kernels.tmr_vote.ops import vote as j_vote
except ImportError:
    jnp = None

DTYPES = {"int32": torch.int32, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _three(shape, dtype_name, seed):
    """Three copies of one random tensor, each with its own bit flips."""
    rs = np.random.RandomState(seed)
    if dtype_name == "int32":
        base = torch.from_numpy(rs.randint(-2**31, 2**31 - 1, size=shape)
                                .astype(np.int32))
    else:
        base = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
            DTYPES[dtype_name])
    out = []
    for _ in range(3):
        x = base.clone()
        raw = _bits(x).view(-1)
        flips = torch.from_numpy(rs.randint(0, raw.numel(),
                                            size=max(1, raw.numel() // 4)))
        raw[flips] ^= torch.from_numpy(
            rs.randint(1, 2**15, size=flips.numel())).to(raw.dtype)
        out.append(x)
    return out


def _jax(x):
    bits = jnp.asarray(_bits(x).numpy())
    return jax.lax.bitcast_convert_type(bits, getattr(jnp, str(x.dtype)[6:]))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (64, 130)])
def test_vote_matches_jax(dtype_name, shape):
    a, b, c = _three(shape, dtype_name,
                     10 * sorted(DTYPES).index(dtype_name) + len(shape))
    want = np.asarray(j_vote(_jax(a), _jax(b), _jax(c)))
    got = vote(a, b, c)
    assert got.dtype == DTYPES[dtype_name]
    np.testing.assert_array_equal(_bits(got).numpy(),
                                  want.view(_bits(got).numpy().dtype))


def test_vote_in_place_into_an_operand():
    a, b, c = _three((9, 4), "bfloat16", 5)
    want = vote_ref(a, b, c)
    out = vote(a, b, c, out=a)
    assert out is a and torch.equal(_bits(a), _bits(want))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 3, 1027, 1 << 20])
def test_kernel_matches_plain_on_card(dtype_name, n):
    dev = _cuda()
    a, b, c = _three((n,), dtype_name, n)
    want = vote_ref(a, b, c)
    got = vote(a.to(dev), b.to(dev), c.to(dev))
    # an odd offset view exercises the byte-wise path
    off = vote(a[1:].to(dev), b[1:].to(dev), c[1:].to(dev))
    torch.cuda.synchronize()
    assert torch.equal(_bits(got.cpu()), _bits(want))
    assert torch.equal(_bits(off.cpu()), _bits(want[1:]))
