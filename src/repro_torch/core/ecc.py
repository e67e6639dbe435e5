"""Diagonal-parity ECC over an m x m crossbar block (port of
`repro.core.ecc`, paper §IV).

Check bits are stored along wrap-around diagonals of each m x m block.
Every diagonal meets each row once and each column once, so the parity
update after an in-row or in-column vectored operation takes O(1) vector
operations (Fig. 2(b)); horizontal parity needs O(n) for one of the two.
The barrel shifter that carries bits along a diagonal (Fig. 2(c)) is an
index gather here.

Parity group of slope s: cell (i, j) belongs to group k = (j - s*i) mod m,
i.e. P_s[k] = XOR_i B[i, (k + s*i) mod m].  A single flipped bit at
(i0, j0) makes every family's syndrome one-hot at k_s = (j0 - s*i0) mod m;
two families with gcd(s_b - s_a, m) = 1 locate it:

    i0 = (k_a - k_b) * inv(s_b - s_a)  (mod m),      j0 = k_a + s_a*i0 (mod m)

The paper's (leading, counter) = (+1, -1) pair locates only for odd m; the
default adds slope 2, so (1, 2) locates for every m and -1 checks.

Data are bool tensors (R, C) with R and C multiples of m; parity is a dict
from slope to a bool (nbi, nbj, m) tensor, as in the reference.  Plain
torch, on the data's device; no kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

__all__ = ["EccConfig", "encode", "syndrome", "correct", "verify",
           "update_parity_col", "update_parity_row", "parity_overhead"]

Parity = Dict[int, torch.Tensor]  # slope -> bool (nbi, nbj, m)


@dataclasses.dataclass(frozen=True)
class EccConfig:
    m: int = 16                       # block size (paper: m ~ 16, n ~ 1024)
    slopes: Tuple[int, ...] = (1, -1, 2)

    def __post_init__(self):
        if self.locating_pair() is None:
            raise ValueError(
                f"no slope pair with gcd(s_b - s_a, m) == 1 for m={self.m}, "
                f"slopes={self.slopes}; cannot locate errors")

    def locating_pair(self) -> Optional[Tuple[int, int]]:
        s = self.slopes
        for a in range(len(s)):
            for b in range(a + 1, len(s)):
                if math.gcd(s[b] - s[a], self.m) == 1:
                    return s[a], s[b]
        return None


def _gather_idx(m: int, s: int, device) -> torch.Tensor:
    """cols[i, k] = (k + s*i) mod m: which column of row i is in group k
    (the floor modulo of torch's `%`, as the reference's, for s < 0)."""
    i = torch.arange(m, device=device)[:, None]
    k = torch.arange(m, device=device)[None, :]
    return (k + s * i) % m


def _blocks(data: torch.Tensor, m: int) -> torch.Tensor:
    r, c = data.shape
    if r % m or c % m:
        raise ValueError(f"data {tuple(data.shape)} not divisible by m={m}")
    return data.reshape(r // m, m, c // m, m).permute(0, 2, 1, 3)


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    return (x.to(torch.uint8).sum(dim) & 1).to(torch.bool)


def encode(data: torch.Tensor, cfg: EccConfig = EccConfig()) -> Parity:
    """Every parity family of a bool matrix (R, C)."""
    m = cfg.m
    b = _blocks(data, m)                                  # (nbi, nbj, m, m)
    rows = torch.arange(m, device=data.device)[:, None]
    parity: Parity = {}
    for s in cfg.slopes:
        gathered = b[..., rows, _gather_idx(m, s, data.device)]  # [.., i, k]
        parity[s] = _xor_reduce(gathered, -2)             # (nbi, nbj, m)
    return parity


def syndrome(data: torch.Tensor, parity: Parity,
             cfg: EccConfig = EccConfig()) -> Parity:
    fresh = encode(data, cfg)
    return {s: fresh[s] ^ parity[s] for s in cfg.slopes}


def verify(data: torch.Tensor, parity: Parity,
           cfg: EccConfig = EccConfig()) -> torch.Tensor:
    """True iff every block of every family has a clean (zero) syndrome."""
    syn = syndrome(data, parity, cfg)
    return ~torch.stack([v.any(-1) for v in syn.values()]).any()


def _modinv(a: int, m: int) -> int:
    a %= m
    for x in range(1, m):
        if (a * x) % m == 1:
            return x
    raise ValueError(f"{a} not invertible mod {m}")


def correct(data: torch.Tensor, parity: Parity,
            cfg: EccConfig = EccConfig()):
    """Detect and correct up to one flipped bit per block.

    Returns new (data, parity, stats); stats holds int32 counters
    corrected_data, corrected_parity and uncorrectable.  Per block:
      * all syndromes zero                         -> clean
      * exactly one family non-zero, one-hot       -> the check bit itself
                                                      flipped: fix parity
      * all families one-hot and consistent        -> a data bit flipped:
                                                      locate, check, flip
      * anything else                              -> uncorrectable
    """
    m = cfg.m
    syn = syndrome(data, parity, cfg)
    slopes = list(cfg.slopes)
    syn_stack = torch.stack([syn[s] for s in slopes])     # (F, nbi, nbj, m)
    pop = syn_stack.sum(-1, dtype=torch.int32)            # (F, nbi, nbj)
    hot = syn_stack.to(torch.uint8).argmax(-1)            # first hot index
    nonzero = pop > 0
    onehot = pop == 1
    n_nonzero = nonzero.sum(0, dtype=torch.int32)         # (nbi, nbj)

    sa, sb = cfg.locating_pair()
    ia, ib = slopes.index(sa), slopes.index(sb)
    inv = _modinv(sb - sa, m)
    i0 = ((hot[ia] - hot[ib]) * inv) % m                  # (nbi, nbj)
    j0 = (hot[ia] + sa * i0) % m
    consistent = torch.ones_like(nonzero[0])
    for f, s in enumerate(slopes):
        consistent &= hot[f] == (j0 - s * i0) % m
    all_onehot = onehot.all(0)

    data_err = (n_nonzero == len(slopes)) & all_onehot & consistent
    parity_err = (n_nonzero == 1) & (onehot | ~nonzero).all(0)
    uncorrectable = (n_nonzero > 0) & ~data_err & ~parity_err

    # data errors: flip bit (i0, j0) of the flagged blocks
    ar = torch.arange(m, device=data.device)
    flip = ((ar[None, None, :, None] == i0[..., None, None])
            & (ar[None, None, None, :] == j0[..., None, None]))
    flip &= data_err[..., None, None]
    b = _blocks(data, m) ^ flip
    data_fixed = b.permute(0, 2, 1, 3).reshape(data.shape)

    # parity errors: the flipped check bit is the syndrome
    parity_fixed: Parity = {}
    for f, s in enumerate(slopes):
        fix_mask = (parity_err & nonzero[f])[..., None] & syn_stack[f]
        parity_fixed[s] = parity[s] ^ fix_mask

    stats = {
        "corrected_data": data_err.sum(dtype=torch.int32),
        "corrected_parity": parity_err.sum(dtype=torch.int32),
        "uncorrectable": uncorrectable.sum(dtype=torch.int32),
    }
    return data_fixed, parity_fixed, stats


# --------------------------------------------------------------------------
# O(1) incremental updates (§IV, Fig. 2(b,c)).  A vectored in-row op
# rewrites one column of the crossbar, an in-column op one row; either
# updates every family in a constant number of vector ops (a permutation,
# the barrel shifter, and an XOR): new parity = old parity ^ old ^ new bit.
# --------------------------------------------------------------------------

def _scatter_mod2(dblk: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """out[:, groups[j]] ^= dblk[:, j] (several j may share a group when
    gcd(s, m) != 1, so an add mod 2, as the reference's scatter-add)."""
    acc = torch.zeros(dblk.shape, dtype=torch.uint8, device=dblk.device)
    acc.index_add_(1, groups, dblk.to(torch.uint8))
    return (acc & 1).to(torch.bool)


def update_parity_col(parity: Parity, old_col: torch.Tensor,
                      new_col: torch.Tensor, col: int,
                      cfg: EccConfig = EccConfig()) -> Parity:
    """Every family after column `col` (all rows at once) was rewritten:
    O(1) vector ops a family, whatever the number of rows.  Returns new
    tables; the given ones are not modified."""
    m = cfg.m
    delta = old_col ^ new_col                             # (R,)
    dblk = delta.reshape(-1, m)                           # (nbi, m): row i
    bj, j_loc = col // m, col % m
    i = torch.arange(m, device=delta.device)
    out: Parity = {}
    for s in cfg.slopes:
        out[s] = parity[s].clone()
        out[s][:, bj, :] ^= _scatter_mod2(dblk, (j_loc - s * i) % m)
    return out


def update_parity_row(parity: Parity, old_row: torch.Tensor,
                      new_row: torch.Tensor, row: int,
                      cfg: EccConfig = EccConfig()) -> Parity:
    """Every family after row `row` (all columns at once) was rewritten: the
    case where horizontal parity costs O(n) (Fig. 2(a)) and diagonal parity
    stays O(1).  Returns new tables."""
    m = cfg.m
    delta = old_row ^ new_row                             # (C,)
    dblk = delta.reshape(-1, m)                           # (nbj, m): col j
    bi, i_loc = row // m, row % m
    j = torch.arange(m, device=delta.device)
    out: Parity = {}
    for s in cfg.slopes:
        out[s] = parity[s].clone()
        out[s][bi, :, :] ^= _scatter_mod2(dblk, (j - s * i_loc) % m)
    return out


def parity_overhead(cfg: EccConfig = EccConfig()) -> float:
    """Storage overhead: |families| * m check bits per m*m data bits."""
    return len(cfg.slopes) / cfg.m
