"""Keyed random streams: the counterpart of `jax.random` as the reference
calls it, bit for bit to jax 0.9.0 with its defaults (the partitionable
threefry, `jax_threefry_partitionable` True, and 32-bit types).

A key is a (2,) int64 tensor holding two uint32 words, on the device it was
made on; every function here computes on its key's device.  All arithmetic
is int64 masked to 32 bits (torch's uint32 ops differ between releases).

* `key(seed)`: ``[0, seed mod 2**32]``, as `jax.random.PRNGKey` gives
  with x64 off (the seed is converted to int32 first).
* `threefry2x32(k0, k1, x0, x1)`: the 20-round Threefry-2x32 hash.
* `split(key, n)`: key i is the hash of the counter (0, i); `fold_in(key,
  d)` is the hash of (0, d).
* `bits(key, shape)`: element i (row-major flat index) is ``b1 ^ b2`` of
  the hash of (i >> 32, i & 0xFFFFFFFF).  Every draw below is a pure
  function of (key, flat index), so each runs in chunks of at most
  `CHUNK` elements on the card, `CPU_CHUNK` on the CPU (`_bits_range`),
  and a plane past 2**32 elements never exists whole.
* `uniform`, `bernoulli`, `randint`, `normal`: `jax.random`'s float32 /
  int32 samplers over those bits.  `bernoulli` rounds p to float32 and
  compares the 23-bit uniform, so its rate is ``ceil(p32 * 2**23) /
  2**23``: at p = 1e-9 the reference flips at 2**-23 (1.19e-7), not 1e-9.
  `word_plane` packs such planes into 32-bit words chunk by chunk.

`normal` is ``sqrt(2) * erfinv(u)`` with u uniform in (-1, 1) and erfinv as
XLA's CPU backend computes it in float32: Giles' polynomials (nine
coefficients a branch, branch at w < 5) of ``w = -log1p(-u*u)``, with XLA's
own log1p (Cephes' rational form below sqrt(2) - 1, else its Cephes log of
1 + x) and every multiply-add fused (emulated in float64; a product of
two float32s is exact there).  Its square root is taken in float64 and
rounded once, the exact float32 root that XLA's is: torch's float32 sqrt
on the CPU is not correctly rounded (`tools/sqrt_rounding.py`), CUDA's
is.  Over 2**20 draws of each
tested seed it equals `jax.random.normal` bit for bit
(`tests/test_torch_prng.py`), and the card equals the CPU.
"""
from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["CHUNK", "key", "is_key", "streams", "threefry2x32",
           "split", "fold_in", "bits", "uniform", "bernoulli", "randint",
           "normal", "threshold", "chunks", "word_plane", "lane_plane"]

M32 = 0xFFFFFFFF
#: the most elements a draw computes at once on the card; on the CPU a
#: chunk's int64 temporaries stay in cache below CPU_CHUNK, which runs the
#: hash three to four times faster there
CHUNK = 1 << 22
CPU_CHUNK = 1 << 16

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _default_device() -> torch.device:
    from ..device import resolve_device
    return resolve_device(None)


def key(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed: ``[0, seed mod 2**32]`` (the reference's
    `jax.random.PRNGKey`, x64 off).  On the port's device unless `device`
    says otherwise."""
    dev = _default_device() if device is None else torch.device(device)
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=dev)


def is_key(x) -> bool:
    """True for a key or a batch of keys (an integer tensor (..., 2));
    False for a `torch.Generator` or None."""
    return isinstance(x, torch.Tensor) and not x.is_floating_point() \
        and x.dim() >= 1 and x.shape[-1] == 2


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, over uint32 values held in int64 tensors
    (k0, k1: ints or 0-d tensors; x0, x1: broadcastable tensors)."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0.add_(x1).bitwise_and_(M32)
            x1 = ((x1 << r).bitwise_and_(M32)).bitwise_or_(x1 >> (32 - r))
            x1 = x1.bitwise_xor_(x0)
        x0 = x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1 = x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(M32)
    return x0, x1


def _pair(k: torch.Tensor):
    """The two words of a key, or of each key of a (..., 2) batch, shaped
    to broadcast against a trailing counter axis."""
    if not isinstance(k, torch.Tensor) or k.is_floating_point() \
            or k.dim() < 1 or k.shape[-1] != 2:
        raise TypeError(f"not a key: {k!r}")
    k = k.to(torch.int64)
    return k[..., 0:1], k[..., 1:2]


def streams(source, n: int) -> list:
    """n fault sources from one: ``split(key, n)`` for a key (the
    reference's subkeys), else the one generator n times, drawn in turn."""
    if is_key(source):
        return list(split(source, n))
    return [source] * n


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` keys, (num, 2): key i hashes the counter (0, i).  A batch of
    keys (..., 2) splits each, to (..., num, 2)."""
    k0, k1 = _pair(k)
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], -1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """A new key from `k` and a 32-bit integer: the hash of (0, data).  A
    1-D tensor of data gives one key each, (n, 2)."""
    k0, k1 = _pair(k)
    x1 = torch.as_tensor(data, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(x1.reshape(-1)),
                          x1.reshape(-1) & M32)
    out = torch.stack([b0, b1], -1)
    return out.reshape(2) if x1.dim() == 0 else out


def _bits_range(k: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Bits of flat indices [start, start + count), int64 in [0, 2**32);
    (count,) for one key, (..., count) for a batch of keys."""
    k0, k1 = _pair(k)
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=k.device)
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return b0.bitwise_xor_(b1).reshape(*k.shape[:-1], count)


def chunks(total: int, step: Optional[int] = None
           ) -> Iterator[Tuple[int, int]]:
    """(start, count) pieces of [0, total), each at most `step` (default
    `CHUNK`)."""
    step = step or CHUNK
    for start in range(0, total, step):
        yield start, min(step, total - start)


def _step(k: torch.Tensor) -> int:
    """The chunk for draws on the key's device."""
    return CHUNK if k.device.type == "cuda" else min(CHUNK, CPU_CHUNK)


def _fill(k: torch.Tensor, shape: Shape, dtype, draw,
          start: int = 0) -> torch.Tensor:
    """`draw` of the bits of flat indices [start, start + prod(shape)),
    chunk by chunk, shaped `shape`."""
    shape = _shape(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=k.device)
    for s, count in chunks(n, _step(k)):
        out[s:s + count] = draw(_bits_range(k, start + s, count))
    return out.reshape(shape)


def bits(k: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """`jax.random.bits`: uint32 values in int64."""
    return _fill(k, shape, torch.int64, lambda b: b)


def _unit(b: torch.Tensor) -> torch.Tensor:
    """The reference's float32 in [0, 1) of 32 random bits: the top 23 bits
    as the mantissa of a number in [1, 2), minus 1."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(k: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform`, float32."""
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))

    def draw(b):
        u = _fma32(_unit(b), span, lo)
        return torch.clamp_min(u, lo)
    return _fill(k, shape, torch.float32, draw)


def threshold(p: float) -> int:
    """The 23-bit mantissas m with ``m * 2**-23 < float32(p)`` are those
    below this: the reference's Bernoulli compares its uniform with p
    rounded to float32."""
    return int(math.ceil(float(np.float32(p)) * 2.0 ** 23))


def bernoulli(k: torch.Tensor, p: float, shape: Shape = ()) -> torch.Tensor:
    """`jax.random.bernoulli` with a Python float p: ``uniform <
    float32(p)``."""
    t = threshold(p)
    return _fill(k, shape, torch.bool, lambda b: (b >> 9) < t)


def randint(k: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """`jax.random.randint` to int32: two bit streams of split keys, the
    high one scaled by 2**32 mod span, summed mod span (span in uint32)."""
    k1, k2 = split(k)
    lo32 = int(np.int32(minval))
    span = (int(maxval) - int(minval)) & M32
    if maxval <= minval:
        span = 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    shape = _shape(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int32, device=k.device)
    for start, count in chunks(n, _step(k)):
        hi = _bits_range(k1, start, count).remainder_(span)
        low = _bits_range(k2, start, count).remainder_(span)
        off = (hi.mul_(mult).bitwise_and_(M32).add_(low)
               .bitwise_and_(M32).remainder_(span))
        # int32 addition wraps: the cast keeps the low 32 bits
        out[start:start + count] = off.add_(lo32).to(torch.int32)
    return out.reshape(shape)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (a product of two float32s is
    exact in float64; the sum is rounded to float64 first, which can differ
    from one rounding only at a float32 tie)."""
    a = a.double()
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).float()


# XLA's float32 log on the CPU (the Cephes polynomial in three parts, as
# Eigen evaluates it), for positive normal inputs
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
# XLA's log1p: Cephes' rational form below |x| < sqrt(2) - 1
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1))


def _horner32(x: torch.Tensor, coeffs) -> torch.Tensor:
    y = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        y = _fma32(y, x, c)
    return y


def _log32(x: torch.Tensor) -> torch.Tensor:
    """float32 log of positive normal x as XLA's CPU backend computes it."""
    xi = x.view(torch.int32)
    e = ((xi >> 23) - 0x7F).float() + 1.0
    m = ((xi & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    below = m < _f32(0.707106781186547524)
    e = e - below.float()
    m = (m - 1.0) + torch.where(below, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma32(torch.full_like(m, p[0]), m, p[1])
    y1 = _fma32(torch.full_like(m, p[3]), m, p[4])
    y2 = _fma32(torch.full_like(m, p[6]), m, p[7])
    y = _fma32(y, m, p[2])
    y1 = _fma32(y1, m, p[5])
    y2 = _fma32(y2, m, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, e * _LOG_Q1)
    m = (m - x2 * 0.5) + y
    return _fma32(e, _LOG_Q2, m)


def _log1p32(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p of x in (-1, 0] as XLA's CPU backend computes it."""
    x2 = x * x
    small = _horner32(x, _LOG1P_NUM) / _horner32(x, _LOG1P_DEN)
    small = x + _fma32(x2, -0.5, x * x2 * small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log32(x + 1.0))


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"): the
# coefficients for w < 5 and for w >= 5, highest power first
_ERFINV_LT5 = tuple(_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(_f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv of x in (-1, 1) as XLA's polynomial computes it."""
    w = -_log1p32(-(x * x))
    lt = w < 5.0
    # the exact float32 root on every device (a double's sqrt rounded to
    # float32 is it): torch's float32 sqrt on the CPU is not always
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, torch.where(lt, a, b))
    return p * x


_SQRT2_32 = float(np.float32(np.sqrt(2)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(k: torch.Tensor, shape: Shape = (), start: int = 0
           ) -> torch.Tensor:
    """`jax.random.normal`, float32: ``sqrt(2) * erfinv(u)`` with u uniform
    in (-1, 1) (module doc).  `start`: the draws of flat indices from
    `start` on of a larger plane under the same key (a range of it drawn
    alone)."""
    def draw(b):
        u = _unit(b) * 2.0 + _NORMAL_LO     # span 2.0: the product is exact
        u = torch.clamp_min(u, _NORMAL_LO)
        return _erfinv32(u) * _SQRT2_32
    return _fill(k, shape, torch.float32, draw, start)


def _pack(planes, shape, width: int, device) -> Tuple[torch.Tensor, ...]:
    """Bool planes (..., width) -> int32 words (...), bit i at [..., i]."""
    shifts = torch.arange(width, dtype=torch.int64, device=device)
    return tuple((p.reshape(*shape, width).to(torch.int64) << shifts)
                 .sum(-1).to(torch.int32) for p in planes)


def word_plane(k: torch.Tensor, n_words: int, fn, *,
               step: Optional[int] = None, start: int = 0):
    """Keyed boolean planes of shape (n_words, 32) packed into int32 words,
    LSB first (the reference's `pack_flip_mask` of planes drawn over
    ``(n_words, 32)``).  `fn` maps a chunk's 23-bit mantissas (the bits >>
    9, int64) to its booleans, or to a tuple of planes: one word tensor
    each.  Computed `step` elements at a time, so no plane exists whole.
    `start`: the words from word `start` on of a larger plane."""
    outs = []
    for w0, nw in list(chunks(n_words, max(1, (step or _step(k)) // 32))) \
            or [(0, 0)]:
        planes = fn(_bits_range(k, (start + w0) * 32, nw * 32) >> 9)
        single = isinstance(planes, torch.Tensor)
        outs.append(_pack((planes,) if single else planes, (nw,), 32,
                          k.device))
    words = tuple(torch.cat(ws) for ws in zip(*outs))
    return words[0] if single else words


def lane_plane(keys: torch.Tensor, trials: int, fn, *,
               step: Optional[int] = None):
    """Per-key boolean planes over `trials`, packed 32 trials a word (the
    reference's `pack_trials` of a plane drawn over ``(trials,)`` under
    each key): keys (G, 2) -> int32 (G, ceil(trials / 32)) for each plane
    `fn` gives (as in `word_plane`); padding lanes are 0."""
    tw = -(-trials // 32)
    outs = []
    rows = max(1, (step or _step(keys)) // max(trials, 1))
    for g0, ng in list(chunks(keys.shape[0], rows)) or [(0, 0)]:
        planes = fn(_bits_range(keys[g0:g0 + ng], 0, trials) >> 9)
        single = isinstance(planes, torch.Tensor)
        padded = []
        for p in ((planes,) if single else planes):
            q = torch.zeros((ng, tw * 32), dtype=torch.bool,
                            device=keys.device)
            q[:, :trials] = p
            padded.append(q)
        outs.append(_pack(padded, (ng, tw), 32, keys.device))
    words = tuple(torch.cat(ws) for ws in zip(*outs))
    return words[0] if single else words
