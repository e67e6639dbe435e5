"""Seed derivation for the port's random streams: the counterpart of the
reference's `jax.random.fold_in`.  The campaign engine derives a batch's
and a sweep point's seed with it, and `core.tmr.tmr` its three copies'."""
from __future__ import annotations

__all__ = ["derive_seed"]

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix64(z: int) -> int:
    """splitmix64's output function (Steele, Lea, Flood 2014)."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive_seed(seed: int, i: int) -> int:
    """The seed of stream i under `seed`, in [0, 2**64): output i + 1 of
    the splitmix64 generator whose state starts at mix(seed + golden).
    Distinct i give distinct, decorrelated seeds; the port's counterpart of
    the reference's `fold_in(key, i)`."""
    state = _mix64((seed + _GOLDEN) & _MASK64)
    return _mix64((state + (i + 1) * _GOLDEN) & _MASK64)
