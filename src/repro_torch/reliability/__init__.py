"""`repro_torch.reliability` -- the protection API (port of
`repro.reliability`): the op registry (`backend`) and the composable
`Scheme` protocol over arena-backed `Protected` stores (`scheme`)."""
from . import backend
from .scheme import (ArenaEcc, Compose, CostReport, DiagParityEcc,
                     HsiaoSecDed, Protected, Scheme, Tmr, Unprotected,
                     parse_scheme, register_scheme, scheme_choices,
                     scheme_help, standard_grid)

__all__ = [
    "backend",
    "Scheme", "Protected", "CostReport",
    "Unprotected", "ArenaEcc", "DiagParityEcc", "HsiaoSecDed", "Tmr",
    "Compose",
    "parse_scheme", "standard_grid", "register_scheme",
    "scheme_choices", "scheme_help",
]
