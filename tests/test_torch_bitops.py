"""The rest of `core/bitops.py` in the port (`rotr32`, `bit_position`,
`float_view_u32`, `u32_view_float`) against the JAX package on the same
numpy words, bit for bit (exact: integer results compared as raw bits)."""
import numpy as np
import pytest
import torch

from repro_torch.core import bitops as TB

try:    # without JAX (as on a GPU machine) only the JAX-free cases run
    import jax
    import jax.numpy as jnp
    from repro.core import bitops as JB
except ImportError:
    jnp = None

needs_jax = pytest.mark.skipif(jnp is None, reason="needs the JAX package")


def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n,
                                                dtype=np.uint64).astype(
                                                    np.uint32)


def _t32(u32):
    return torch.from_numpy(u32.view(np.int32).copy())


def _bits32(t):
    return t.numpy().astype(np.int64).astype(np.uint64).astype(np.uint32) \
        if t.dtype == torch.int64 else t.numpy().view(np.uint32)


@needs_jax
@pytest.mark.parametrize("r", [0, 1, 5, 16, 31, 32, 33, 100])
def test_rotr32_scalar_matches_jax(r):
    x = _u32(1000, r + 100)
    got = TB.rotr32(_t32(x), r)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_bits32(got),
                                  np.asarray(JB.rotr32(jnp.asarray(x), r)))
    # unsigned values in int64 give the same bits
    got64 = TB.rotr32(torch.from_numpy(x.astype(np.int64)), r)
    np.testing.assert_array_equal(_bits32(got64), _bits32(got))


def test_rotr32_negative_shift_is_floor_modulo():
    """The reference takes r as uint32 (no negative shift); the port reads
    r mod 32, so -r rotates right by 32 - r."""
    x = _t32(_u32(300, 8))
    for r in (-1, -7, -33):
        assert torch.equal(TB.rotr32(x, r), TB.rotr32(x, r % 32))
        assert torch.equal(TB.rotr32(x, r), TB.rotl32(TB.as_u64(x), -r % 32))


@needs_jax
def test_rotr32_tensor_shift_matches_jax():
    x = _u32(64 * 32, 7).reshape(64, 32)
    r = (np.arange(32) * 3) % 32
    got = TB.rotr32(_t32(x), torch.from_numpy(r.astype(np.int64)))
    want = JB.rotr32(jnp.asarray(x), jnp.asarray(r, jnp.uint32))
    np.testing.assert_array_equal(_bits32(got), np.asarray(want))
    # rotr undoes rotl
    back = TB.rotl32(got, torch.from_numpy(r.astype(np.int64)))
    np.testing.assert_array_equal(_bits32(back), x)


@needs_jax
@pytest.mark.parametrize("kind", ["single", "zero", "multi"])
def test_bit_position_matches_jax(kind):
    rng = np.random.default_rng({"single": 1, "zero": 2, "multi": 3}[kind])
    if kind == "single":
        x = (np.uint32(1) << rng.integers(0, 32, 500).astype(np.uint32))
    elif kind == "zero":
        x = np.zeros(17, np.uint32)
    else:   # several set bits: both give the sum of the indices
        x = _u32(500, 4)
    got = TB.bit_position(_t32(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JB.bit_position(jnp.asarray(x))))


def _float_bits(dtype, n, seed):
    """Random raw bit patterns of `dtype` (NaNs, infinities and denormals
    included) as numpy unsigned ints."""
    width = 32 if dtype == torch.float32 else 16
    u = np.random.default_rng(seed).integers(0, 2**width, n, dtype=np.uint64)
    return u.astype(np.uint32 if width == 32 else np.uint16)


def _torch_from_bits(u, dtype):
    signed = np.int32 if u.dtype == np.uint32 else np.int16
    return torch.from_numpy(u.view(signed).copy()).view(dtype)


@needs_jax
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_view_u32_matches_jax(dtype):
    u = _float_bits(dtype, 4099, 11)
    x = _torch_from_bits(u, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jax.lax.bitcast_convert_type(jnp.asarray(u), jdt)
    got = TB.float_view_u32(x)
    assert got.element_size() == x.element_size()
    np.testing.assert_array_equal(got.numpy().view(u.dtype),
                                  np.asarray(JB.float_view_u32(jx)))


def test_float_view_u32_fp16_and_int32():
    """float16 has no case in the reference (it raises there); the port
    gives its raw 16 bits, numpy's view of the same values.  int32 words
    pass through."""
    u = _float_bits(torch.bfloat16, 999, 12)
    x = torch.from_numpy(u.view(np.float16).copy())
    np.testing.assert_array_equal(TB.float_view_u32(x).numpy().view(
        np.uint16), u)
    w = _u32(100, 13)
    np.testing.assert_array_equal(TB.float_view_u32(_t32(w)).numpy().view(
        np.uint32), w)
    with pytest.raises(TypeError):
        TB.float_view_u32(torch.zeros(3, dtype=torch.float64))


@needs_jax
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_u32_view_float_matches_jax(dtype):
    u = _float_bits(dtype, 2053, 21)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax.lax.bitcast_convert_type(
        JB.u32_view_float(jnp.asarray(u.astype(np.uint32)), jdt),
        jnp.uint32 if dtype == torch.float32 else jnp.uint16))
    signed = np.int32 if dtype == torch.float32 else np.int16
    # from unsigned values in int64 (the reference's uint32 argument) and
    # from the raw-bit view
    for bits in (torch.from_numpy(u.astype(np.int64)),
                 torch.from_numpy(u.view(signed).copy())):
        got = TB.u32_view_float(bits, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(
            got.view(torch.int32 if dtype == torch.float32
                     else torch.int16).numpy().view(u.dtype), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32])
def test_views_round_trip(dtype):
    x = _torch_from_bits(_float_bits(torch.float32 if dtype in (
        torch.float32, torch.int32) else torch.bfloat16, 777, 30), dtype)
    back = TB.u32_view_float(TB.float_view_u32(x), dtype)
    assert back.dtype == dtype
    assert torch.equal(back.view(torch.uint8), x.view(torch.uint8))
