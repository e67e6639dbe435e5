"""MultPIM-style in-memory fixed-point multiplication (port of
`repro.core.multpim`, paper §VI-A).

An N x N-bit unsigned array multiplier built from the FELIX gate set,
expressed as a Min3 netlist: partial products via NAND+NOT, carry-save
accumulation rows of full adders, final ripple carry-propagate adder.  For
N = 32 this is 13,792 stateful gates, and the error-injection experiments
inject faults into exactly these gate requests, accounting for logical
masking, as the paper's modified simulator does.

The TMR experiment wraps this netlist per §V: three executions + per-bit
Minority3 voting (the voting gates are fault-injected too: "non-ideal
voting").  Every function takes tensors and runs on the operands' device;
a `torch.Generator` takes the place of the reference's key.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..reliability import backend
from . import prng
from .bitops import MASK32, as_unsigned, from_bits, to_bits
from .netlist import Netlist, NetlistBuilder, full_adder
from .stateful_logic import g_maj3

__all__ = ["multiplier_netlist", "multiply_bits", "multiply_words",
           "multiply_tmr_bits", "true_product_bits", "execute_netlist"]


def execute_netlist(nl: Netlist, inputs: torch.Tensor,
                    generator: Optional[torch.Generator] = None, p_gate=0.0,
                    fault_gate: Optional[torch.Tensor] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch a netlist execution through the backend registry (op
    ``netlist_exec``: "kernel" -- one CUDA launch, the default; "level" --
    the levelized plain version; "scan" -- the gate-serial reference).  All
    three are bit-exact to each other, fault streams included."""
    fn = backend.dispatch("netlist_exec", impl)
    return fn(nl, inputs, generator=generator, p_gate=p_gate,
              fault_gate=fault_gate)


@functools.lru_cache(maxsize=None)
def multiplier_netlist(n_bits: int, cse: bool = True) -> Netlist:
    """Build the N-bit unsigned multiplier netlist (cached per width).

    Inputs: a[0..N-1] LSB-first, then b[0..N-1].  Outputs: product, 2N bits
    LSB-first.  cse=False keeps structurally duplicate gates (the honest
    hand-mapped micro-code count).
    """
    bld = NetlistBuilder(cse=cse)
    a = bld.input_bits(n_bits)
    b = bld.input_bits(n_bits)

    # partial products pp[i][j] = a[j] & b[i]
    pp = [[bld.and_(a[j], b[i]) for j in range(n_bits)] for i in range(n_bits)]

    prod = [bld.ZERO] * (2 * n_bits)
    # carry-save accumulation: S/C words aligned at the current row weight
    S = list(pp[0])            # S[j] has weight 2^(i+j) after row i
    C = [bld.ZERO] * n_bits
    prod[0] = S[0]
    for i in range(1, n_bits):
        newS, newC = [], []
        for j in range(n_bits):
            s_above = S[j + 1] if j + 1 < n_bits else bld.ZERO
            s, c = full_adder(bld, pp[i][j], s_above, C[j])
            newS.append(s)
            newC.append(c)
        S, C = newS, newC
        prod[i] = S[0]
    # final carry-propagate add of the leftover S (shifted) and C words
    carry = bld.ZERO
    for j in range(n_bits):
        u = S[j + 1] if j + 1 < n_bits else bld.ZERO
        s, carry = full_adder(bld, u, C[j], carry)
        prod[n_bits + j] = s
    bld.mark_outputs(prod)
    return bld.build()


def _pack_inputs(a_words: torch.Tensor, b_words: torch.Tensor,
                 n_bits: int) -> torch.Tensor:
    return torch.cat([to_bits(a_words, n_bits), to_bits(b_words, n_bits)],
                     dim=-1)


def multiply_bits(a_words: torch.Tensor, b_words: torch.Tensor, n_bits: int,
                  generator: Optional[torch.Generator] = None, p_gate=0.0,
                  fault_gate: Optional[torch.Tensor] = None,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Multiply batches of N-bit words (int32 words read as unsigned, or
    int64) through the in-memory netlist.

    p_gate may be a float rate or any faults.FaultModel; impl selects the
    execution engine (backend registry op ``netlist_exec``) -- the result
    is bit-exact across engines.  Returns the 2N-bit product as a bool
    bit-plane (trials, 2N), LSB first.
    """
    nl = multiplier_netlist(n_bits)
    return execute_netlist(nl, _pack_inputs(a_words, b_words, n_bits),
                           generator=generator, p_gate=p_gate,
                           fault_gate=fault_gate, impl=impl)


def multiply_words(a_words: torch.Tensor, b_words: torch.Tensor, n_bits: int,
                   generator: Optional[torch.Generator] = None, p_gate=0.0,
                   fault_gate: Optional[torch.Tensor] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """As multiply_bits but packed to (trials, 2) int32 words (lo, hi)."""
    bits = multiply_bits(a_words, b_words, n_bits, generator, p_gate,
                         fault_gate, impl=impl)
    return torch.stack([from_bits(bits[..., :n_bits]),
                        from_bits(bits[..., n_bits:])], dim=-1)


def multiply_tmr_bits(a_words: torch.Tensor, b_words: torch.Tensor,
                      n_bits: int, generator: torch.Generator, p_gate,
                      ideal_voting: bool = False,
                      impl: Optional[str] = None) -> torch.Tensor:
    """TMR multiplication (serial discipline): three netlist executions with
    independent fault streams, then per-bit Minority3+NOT voting.  Copy 1,
    copy 2, copy 3 and then the voting gates draw from `generator` in that
    order.

    With ideal_voting=False the two voting gates per output bit are
    fault-injected as well (paper Fig. 4: non-ideal voting becomes the
    bottleneck near p_gate = 1e-9).  Returns bool bits (trials, 2N).  A
    `core.prng` key is split in four (copies 1-3, the voting gates), as
    the reference splits it.
    """
    nl = multiplier_netlist(n_bits)
    inputs = _pack_inputs(a_words, b_words, n_bits)
    sources = prng.streams(generator, 4)
    o1, o2, o3 = (execute_netlist(nl, inputs, generator=g,
                                  p_gate=p_gate, impl=impl)
                  for g in sources[:3])
    if ideal_voting:
        return g_maj3(o1, o2, o3)
    return g_maj3(o1, o2, o3, sources[3], p_gate)


def true_product_bits(a_words: torch.Tensor, b_words: torch.Tensor,
                      n_bits: int) -> torch.Tensor:
    """Oracle product bits (trials, 2N), exact integer arithmetic on the
    operands' device: the 64-bit product is formed from two products of 48
    bits each, so no int64 product overflows."""
    a, b = as_unsigned(a_words), as_unsigned(b_words)
    x, y = a * (b & 0xFFFF), a * (b >> 16)          # each < 2^48
    lo = (x & MASK32) + ((y & 0xFFFF) << 16)
    hi = (x >> 32) + (y >> 16) + (lo >> 32)
    bits = torch.cat([to_bits(lo & MASK32, 32), to_bits(hi, 32)], dim=-1)
    return bits[..., :2 * n_bits]
