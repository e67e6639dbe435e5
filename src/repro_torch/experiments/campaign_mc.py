"""Monte Carlo reproduction of the paper's Fig. 4 and Fig. 5 (port of
`benchmarks/campaign_mc.py`, §VI).

Where `fig4_nn` and `fig5_weights` extrapolate closed forms
(`core.analytics`), this module measures the same quantities with the
campaign engine (`faults.campaign`) and checks that the closed forms lie
inside the campaigns' 99% Wilson intervals:

* Fig. 4: multiplication failure and a scaled NN misclassification against
  p_gate.  A trial pushes random operands through the MultPIM Min3 netlist
  with i.i.d. gate faults (`netlist_exec`, one launch a batch).  The
  paper's p_gate ~ 1e-9 is out of reach of direct Monte Carlo, so the
  campaigns run at feasible rates and check the model the extrapolation
  rests on.  TMR is reported only: `p_mult_tmr` is a word-level upper bound.
* Fig. 5: long-term weight corruption under ECC scrubbing.  A trial is one
  32-word block over T scrub intervals; a batch is one fused
  inject -> scrub launch an interval over all its blocks
  (`kernels/inject_scrub`), checked against `weight_corruption_ecc(m=32)`.
* The scheme grid walks the `repro_torch.reliability` design space
  (unprotected, ECC, the three TMR disciplines, ECC+TMR) through one
  `sweep_schemes` path; every protected scheme must beat or tie the
  unprotected baseline.  Its trials are batched over blocks: n trials are
  one payload of n blocks, protected once, corrupted and scrubbed T times,
  and a trial fails when its own 32 words differ (the reference vmaps one
  block a trial; blocks are independent under every scheme of the grid).

    python -m repro_torch.experiments.campaign_mc [--device cpu] [--smoke]

prints one ``name,us_per_trial,derived`` row a line, as the reference
does; `derived` adds each campaign's host-clock seconds, trials per second
and, on a CUDA device, its peak device memory.  Full mode: the 32-bit
multiplier at the reference's budgets; smoke: the 16-bit one and smaller
budgets.  A failed check raises AssertionError.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Tuple

import numpy as np
import torch

from ..core import analytics as A
from ..core import multpim, prng
from ..device import resolve_device
from ..faults import (CampaignConfig, CampaignResult, TransientBitFlips,
                      derive_seed, run_campaign, sweep, sweep_schemes)
from ..faults.campaign import child_seed
from ..reliability import backend, standard_grid

__all__ = ["Mode", "FULL", "SMOKE", "Z", "FIG5_POINTS", "GRID_P_INPUT",
           "GRID_T", "SEED", "store_config", "measure_alpha",
           "make_mult_trial", "make_nn_trial", "make_fig5_trial",
           "make_scheme_trial", "fig4", "fig5", "scheme_grid", "run"]

#: a 99% Wilson interval: a closed form outside it is a model or code
#: fault, not 1-in-20 Monte Carlo noise
Z = 2.576
FIG5_POINTS = ({"p_input": 1e-4, "T": 8}, {"p_input": 5e-4, "T": 8})
#: the scheme grid's operating point (§V-§VI design space): high enough
#: that the unprotected baseline visibly fails over the horizon
GRID_P_INPUT, GRID_T = 2e-4, 4
#: the campaigns' root seed (the reference's PRNGKey(2021))
SEED = 2021


@dataclasses.dataclass(frozen=True)
class Mode:
    """The reference's budgets (`benchmarks/campaign_mc.py:57-72`)."""
    n_bits: int                   # multiplier width
    max_trials: int
    batch: int
    fig4_pgates: Tuple[float, ...]  # Monte Carlo-feasible operating points
    m_scaled: int                 # scaled NN: multiplications a sample
    p_mask_scaled: float          # scaled NN: P[a wrong product flips it]
    grid_max_trials: int

    def config(self) -> CampaignConfig:
        return CampaignConfig(batch_size=self.batch,
                              max_trials=self.max_trials,
                              min_trials=min(self.batch * 2, self.max_trials),
                              ci_halfwidth=0.02, z=Z)

    def grid_config(self) -> CampaignConfig:
        return CampaignConfig(batch_size=min(self.batch, 256),
                              max_trials=self.grid_max_trials,
                              min_trials=256, ci_halfwidth=0.03, z=Z)


FULL = Mode(32, 4096, 1024, (1e-5, 3e-5), 16, 0.25, 1024)
SMOKE = Mode(16, 2048, 512, (3e-5, 1e-4), 8, 0.25, 512)


def store_config(n_blocks: int) -> CampaignConfig:
    """One batch of n_blocks trials: a whole store scrubbed at once."""
    return CampaignConfig(batch_size=n_blocks, max_trials=n_blocks,
                          min_trials=n_blocks, ci_halfwidth=0.0, z=Z)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _operand_words(g: torch.Generator, n: int, n_bits: int) -> torch.Tensor:
    return torch.randint(0, 2**n_bits, (n,), dtype=torch.int64,
                         generator=g, device=g.device)


def _random_words(g: torch.Generator, n: int) -> torch.Tensor:
    """n uniformly random 32-bit words (int32 storage)."""
    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int64, generator=g,
                         device=g.device).to(torch.int32)


def measure_alpha(n_bits: int = 32, device=None) -> float:
    """Exhaustive single-fault masking fraction: one trial a gate position,
    on operands drawn from numpy's default_rng(0), a then b (as
    `benchmarks/fig4_mult.py` draws them)."""
    dev = resolve_device(device)
    nl = multpim.multiplier_netlist(n_bits)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 2**n_bits, nl.n_gates,
                                          dtype=np.uint64).astype(np.int64))
            .to(dev) for _ in range(2))
    bits = multpim.multiply_bits(
        a, b, n_bits, fault_gate=torch.arange(nl.n_gates, device=dev))
    want = multpim.true_product_bits(a, b, n_bits)
    return int((bits != want).any(1).sum()) / nl.n_gates


# -- Fig. 4 campaigns ---------------------------------------------------------

def make_mult_trial(p_gate: float, tmr: bool = False, n_bits: int = 32):
    """Batched trial: n multiplications of random operands; a trial fails
    when any product bit is wrong (the oracle product stands for the
    reference's fault-free netlist run, which equals it).  With a
    `core.prng` key, the reference benchmark's draws: ``split(key, 3)``
    for a, b and the faults."""
    def trial(g: torch.Generator, n: int) -> torch.Tensor:
        if prng.is_key(g):
            lim = 0xFFFFFFFF >> (32 - n_bits)
            ka, kb, g = prng.split(g, 3)
            a, b = prng.bits(ka, n) & lim, prng.bits(kb, n) & lim
        else:
            a, b = (_operand_words(g, n, n_bits),
                    _operand_words(g, n, n_bits))
        if tmr:
            bits = multpim.multiply_tmr_bits(a, b, n_bits, g, p_gate)
        else:
            bits = multpim.multiply_bits(a, b, n_bits, generator=g,
                                         p_gate=p_gate)
        return (bits != multpim.true_product_bits(a, b, n_bits)).any(-1)
    return trial


def make_nn_trial(p_gate: float, n_bits: int = 32, m_scaled: int = 16,
                  p_mask_scaled: float = 0.25):
    """Batched trial: a sample is m_scaled multiplications through the
    netlist; each wrong product flips the classification w.p.
    p_mask_scaled.  With a `core.prng` key, the reference benchmark's
    draws: ``split(key, 4)`` for a, b, the faults and the masking."""
    def trial(g: torch.Generator, n: int) -> torch.Tensor:
        k = n * m_scaled
        keyed = prng.is_key(g)
        if keyed:
            lim = 0xFFFFFFFF >> (32 - n_bits)
            ka, kb, g, km = prng.split(g, 4)
            a, b = prng.bits(ka, k) & lim, prng.bits(kb, k) & lim
        else:
            a, b = (_operand_words(g, k, n_bits),
                    _operand_words(g, k, n_bits))
        bits = multpim.multiply_bits(a, b, n_bits, generator=g,
                                     p_gate=p_gate)
        wrong = (bits != multpim.true_product_bits(a, b, n_bits)).any(-1)
        flips = prng.bernoulli(km, p_mask_scaled, (n, m_scaled)) if keyed \
            else torch.rand((n, m_scaled), generator=g,
                            device=g.device) < p_mask_scaled
        return (wrong.view(n, m_scaled) & flips).any(-1)
    return trial


# -- Fig. 5 campaign ----------------------------------------------------------

def make_fig5_trial(p_input: float, T: int):
    """Batched trial: a trial is one 32-word ECC block over T scrub
    intervals, and a batch of n blocks takes one fused inject_scrub launch
    an interval.  A trial fails when its block differs from the original
    at the horizon.  Extras: corrected and uncorrectable blocks, summed
    over the intervals."""
    model = TransientBitFlips(p_input)

    def trial(g: torch.Generator, n: int):
        buf = _random_words(g, n * 32)
        orig = buf.clone()
        par = backend.dispatch("diag_parity").encode(buf)
        inject_scrub = backend.dispatch("inject_scrub")
        corrected = torch.zeros((), dtype=torch.int64, device=buf.device)
        uncorrectable = torch.zeros_like(corrected)
        for _ in range(T):
            _, par, counts = inject_scrub(buf, par, model.word_mask(g, buf))
            corrected += counts[1]
            uncorrectable += counts[3]
        fail = (buf.view(n, 32) != orig.view(n, 32)).any(-1)
        return fail, {"corrected": corrected, "uncorrectable": uncorrectable}
    return trial


# -- protection-scheme design-space grid --------------------------------------

def make_scheme_trial(scheme, p_input: float = GRID_P_INPUT,
                      T: int = GRID_T):
    """Batched trial over blocks: n trials are one payload {"w": n*32
    words} protected by `scheme`, corrupted and scrubbed over T exposure
    intervals; trial i fails when words [32i, 32i+32) of the decoded
    payload differ from the original.  The leaf starts the arena, so its
    32-word blocks are the arena's blocks.  One closure for every scheme:
    the §V-§VI design space through one code path."""
    model = TransientBitFlips(p_input)

    def trial(g: torch.Generator, n: int) -> torch.Tensor:
        w = _random_words(g, n * 32)
        prot = scheme.protect({"w": w})
        for _ in range(T):
            prot = scheme.corrupt_store(prot, model, g)
            prot, _ = scheme.scrub(prot)
        got = scheme.read(prot)["w"]
        return (got.view(n, 32) != w.view(n, 32)).any(-1)
    return trial


# -- the sections -------------------------------------------------------------

Row = Tuple[str, float, str]


def _measured(res: CampaignResult) -> str:
    """Seconds, trials per second and peak device memory of a campaign."""
    s = (f" s={res.seconds:.3f} "
         f"trials_per_s={res.n_trials / max(res.seconds, 1e-9):.0f}")
    if res.peak_bytes is not None:
        s += f" peak_gb={res.peak_bytes / 1e9:.2f}"
    return s


def _us(res: CampaignResult) -> float:
    return res.seconds * 1e6 / max(res.n_trials, 1)


def fig4(alpha: float, mode: Mode = FULL, device=None, seed: int = SEED
         ) -> Tuple[List[Row], List[CampaignResult]]:
    """The multiplication and NN campaigns against their closed forms (each
    inside its 99% interval), and the TMR point beside its upper bound.
    `seed` may be a `core.prng` key: the campaigns then make the reference
    benchmark's draws (point i under ``fold_in(key, i)``, NN point i under
    ``fold_in(key, 100 + i)``, TMR under ``fold_in(key, 200)``)."""
    cfg = mode.config()
    G = multpim.multiplier_netlist(mode.n_bits).n_gates
    rows, results = [], []
    for i, p_gate in enumerate(mode.fig4_pgates):
        res = run_campaign(make_mult_trial(p_gate, n_bits=mode.n_bits),
                           child_seed(seed, i), cfg, batched=True,
                           name=f"mult p_gate={p_gate:g}", device=device)
        model = float(A.p_mult_from_alpha(np.array([p_gate]), alpha, G)[0])
        lo, hi = res.ci
        agree = res.contains(model)
        rows.append((f"campaign_mc.fig4_mult_p{p_gate:g}", _us(res),
                     f"p_hat={res.p_hat:.4f} ci=[{lo:.4f},{hi:.4f}] "
                     f"model={model:.4f} n={res.n_trials} agree={agree}"
                     + _measured(res)))
        results.append(res)
        _require(agree, f"fig4 p_gate={p_gate:g}: closed form {model:.4f} "
                 f"outside Wilson interval [{lo:.4f}, {hi:.4f}] "
                 f"(n={res.n_trials})")

    cs = A.AlexNetCaseStudy(M=mode.m_scaled, p_mask=mode.p_mask_scaled)
    for i, p_gate in enumerate(mode.fig4_pgates):
        res = run_campaign(
            make_nn_trial(p_gate, mode.n_bits, mode.m_scaled,
                          mode.p_mask_scaled),
            child_seed(seed, 100 + i), cfg, batched=True,
            name=f"nn p_gate={p_gate:g}", device=device)
        p_mult = A.p_mult_from_alpha(np.array([p_gate]), alpha, G)
        model = float(A.nn_misclassification(p_mult, cs)[0])
        lo, hi = res.ci
        agree = res.contains(model)
        rows.append((f"campaign_mc.fig4_nn_p{p_gate:g}", _us(res),
                     f"p_hat={res.p_hat:.4f} ci=[{lo:.4f},{hi:.4f}] "
                     f"model={model:.4f} M={mode.m_scaled} agree={agree}"
                     + _measured(res)))
        results.append(res)
        _require(agree, f"fig4_nn p_gate={p_gate:g}: closed form "
                 f"{model:.4f} outside Wilson interval [{lo:.4f}, {hi:.4f}] "
                 f"(n={res.n_trials})")

    p_tmr = mode.fig4_pgates[-1]
    res = run_campaign(make_mult_trial(p_tmr, tmr=True, n_bits=mode.n_bits),
                       child_seed(seed, 200), cfg, batched=True,
                       name=f"tmr p_gate={p_tmr:g}", device=device)
    bound = float(A.p_mult_tmr(np.array([p_tmr]), alpha, G)[0])
    lo, hi = res.ci
    rows.append((f"campaign_mc.fig4_tmr_p{p_tmr:g}", _us(res),
                 f"p_hat={res.p_hat:.4f} ci=[{lo:.4f},{hi:.4f}] "
                 f"upper_bound={bound:.4f} below_bound={lo <= bound}"
                 + _measured(res)))
    results.append(res)
    return rows, results


def fig5(cfg: CampaignConfig, device=None, seed: int = SEED
         ) -> Tuple[List[Row], List[CampaignResult]]:
    """The Fig. 5 sweep over FIG5_POINTS, each point's p_hat against
    weight_corruption_ecc(m=32) inside its 99% interval."""
    rows, results = [], []
    for pt, res in sweep(make_fig5_trial, FIG5_POINTS,
                         derive_seed(seed, 300), cfg, batched=True,
                         device=device):
        model = float(A.weight_corruption_ecc(pt["p_input"],
                                              np.array([pt["T"]]), m=32)[0])
        lo, hi = res.ci
        agree = res.contains(model)
        rows.append((f"campaign_mc.fig5_p{pt['p_input']:g}_T{pt['T']}",
                     _us(res),
                     f"p_hat={res.p_hat:.4f} ci=[{lo:.4f},{hi:.4f}] "
                     f"model={model:.4f} n={res.n_trials} "
                     f"corrected={res.extras['corrected']:.0f} "
                     f"uncorrectable={res.extras['uncorrectable']:.0f} "
                     f"agree={agree}" + _measured(res)))
        results.append(res)
        _require(agree, f"fig5 {pt}: closed form {model:.4f} outside Wilson "
                 f"interval [{lo:.4f}, {hi:.4f}] (n={res.n_trials})")
    return rows, results


def scheme_grid(cfg: CampaignConfig, device=None, seed: int = SEED
                ) -> Tuple[List[Row], List[CampaignResult]]:
    """Long-term block corruption across `standard_grid()`; every
    protected scheme must beat or tie unprotected + 0.02."""
    rows, results, p_hats = [], [], {}
    for scheme, res in sweep_schemes(make_scheme_trial, standard_grid(),
                                     derive_seed(seed, 400), cfg,
                                     batched=True, device=device):
        lo, hi = res.ci
        p_hats[scheme.name] = res.p_hat
        rows.append((f"campaign_mc.scheme_{scheme.name}", _us(res),
                     f"p_hat={res.p_hat:.4f} ci=[{lo:.4f},{hi:.4f}] "
                     f"n={res.n_trials} p_input={GRID_P_INPUT:g} T={GRID_T} "
                     f"cost[{scheme.overhead().describe()}]"
                     + _measured(res)))
        results.append(res)
    for name, p_hat in p_hats.items():
        if name != "unprotected":
            _require(p_hat <= p_hats["unprotected"] + 0.02,
                     f"scheme {name} (p_hat={p_hat:.4f}) worse than "
                     f"unprotected ({p_hats['unprotected']:.4f})")
    return rows, results


def run(device=None, smoke: bool = False) -> List[Row]:
    """Every campaign on `device` (CUDA unless the caller passes the CPU)
    at the reference's budgets; rows ``(name, us_per_trial, derived)``
    with the reference's names."""
    dev = resolve_device(device)
    mode = SMOKE if smoke else FULL
    nl = multpim.multiplier_netlist(mode.n_bits)
    t0 = time.perf_counter()
    alpha = measure_alpha(mode.n_bits, dev)
    rows = [("campaign_mc.alpha", (time.perf_counter() - t0) * 1e6
             / nl.n_gates, f"alpha={alpha:.4f} gates={nl.n_gates} "
             f"n_bits={mode.n_bits}")]
    rows += fig4(alpha, mode, dev)[0]
    rows += fig5(mode.config(), dev)[0]
    rows += scheme_grid(mode.grid_config(), dev)[0]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--smoke", action="store_true",
                    help="16-bit multiplier and smaller budgets")
    args = ap.parse_args(argv)
    for name, us, derived in run(args.device, args.smoke):
        print(f"{name},{us:.3f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
