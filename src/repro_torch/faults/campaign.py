"""Batched Monte Carlo fault campaigns with streaming Wilson statistics
(port of `repro.faults.campaign`).

A campaign estimates a failure probability: it runs many independent
trials, streams the pass/fail counts and reports a Wilson score interval.

* **batched**: a batch of trials runs as one call of the trial function on
  the device; failures and extras are summed there, and only the scalars
  cross to the host, one sync a batch;
* **deterministic**: batch b draws from a `torch.Generator` seeded with
  `derive_seed(seed, b)`, so a campaign replays from (seed, config) alone,
  as the reference's does from (key, config) through `fold_in`;
* **early stop**: after `min_trials` the campaign stops as soon as the
  Wilson half-width is at most `ci_halfwidth` (0 disables);
* **sweeps**: `sweep` runs one campaign a grid point and `sweep_schemes` one
  a protection scheme; point i's seed is `derive_seed(seed, i)`.

Trials may also return per-trial counters (corrected, uncorrectable, ...)
as a dict of tensors; they are summed into `CampaignResult.extras` by the
same reduction.  Each result also records its host-clock seconds and, on a
CUDA device, the device's peak allocated bytes during the campaign.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from ..core import prng
from ..core.seeds import derive_seed
from ..device import resolve_device

__all__ = ["CampaignConfig", "CampaignResult", "derive_seed", "child_seed",
           "wilson_interval", "run_campaign", "sweep", "sweep_schemes"]


def wilson_interval(k: int, n: int, z: float = 1.96) -> Tuple[float, float]:
    """Wilson score interval for k failures in n Bernoulli trials.

    Preferred over the normal approximation because campaign operating
    points sit in the rare-event regime (k near 0), where Wald intervals
    collapse to a width-0 lie.
    """
    if n <= 0:
        return 0.0, 1.0
    p = k / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    return max(0.0, center - half), min(1.0, center + half)


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    batch_size: int = 256        # trials per device call
    max_trials: int = 4096       # hard budget
    min_trials: int = 512        # never early-stop before this many
    ci_halfwidth: float = 0.0    # stop once Wilson half-width <= this (0 = off)
    z: float = 1.96              # 95% interval


@dataclasses.dataclass
class CampaignResult:
    """Streaming summary of one campaign (one operating point).  `seconds`
    (host clock, the first batch to the last sync) and `peak_bytes` (CUDA
    only, else None) are measurements, not part of the estimate."""

    name: str
    n_trials: int
    failures: int
    z: float = 1.96
    extras: Dict[str, float] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    peak_bytes: Optional[int] = None

    @property
    def p_hat(self) -> float:
        return self.failures / self.n_trials if self.n_trials else 0.0

    @property
    def ci(self) -> Tuple[float, float]:
        return wilson_interval(self.failures, self.n_trials, self.z)

    @property
    def ci_halfwidth(self) -> float:
        lo, hi = self.ci
        return (hi - lo) / 2.0

    def contains(self, p_model: float) -> bool:
        """Does the closed-form prediction fall inside the Wilson interval?"""
        lo, hi = self.ci
        return lo <= p_model <= hi

    def describe(self) -> str:
        lo, hi = self.ci
        s = (f"{self.name}: p_hat={self.p_hat:.4g} "
             f"[{lo:.4g}, {hi:.4g}] n={self.n_trials}")
        if self.extras:
            s += " " + " ".join(f"{k}={v:g}" for k, v in
                                sorted(self.extras.items()))
        return s


def _normalize(out) -> Tuple[torch.Tensor, Mapping[str, Any]]:
    if isinstance(out, tuple):
        fail, extras = out
        return torch.as_tensor(fail), extras
    return torch.as_tensor(out), {}


def _generator(device: torch.device, seed) -> torch.Generator:
    """A batch's fault source: a generator seeded `seed`, or the key."""
    if prng.is_key(seed):
        return seed.to(device)
    return torch.Generator(device=device).manual_seed(seed)


def child_seed(seed, i: int):
    """Stream i under `seed`: derive_seed(seed, i), or fold_in(key, i)."""
    if prng.is_key(seed):
        return prng.fold_in(seed, i)
    return derive_seed(seed, i)


def _per_trial(trial_fn: Callable, device: torch.device) -> Callable:
    """A batch of `trial_fn(generator)` calls, trial j of a batch on the
    generator seeded derive_seed(batch seed, j), or on ``split(batch key,
    n)[j]`` (the reference's keys; it vmaps the trials)."""
    def batch_fn(seed, n):
        sources = list(prng.split(seed.to(device), n)) if \
            prng.is_key(seed) else \
            [_generator(device, derive_seed(seed, j)) for j in range(n)]
        outs = [_normalize(trial_fn(g)) for g in sources]
        fail = torch.stack([f.reshape(()) for f, _ in outs])
        keys = outs[0][1].keys() if outs else ()
        extras = {k: torch.stack([torch.as_tensor(e[k]).reshape(())
                                  for _, e in outs]) for k in keys}
        return fail, extras
    return batch_fn


def run_campaign(trial_fn: Callable, seed: int,
                 cfg: CampaignConfig = CampaignConfig(), *,
                 batched: bool = False, name: str = "",
                 device=None) -> CampaignResult:
    """Estimate P[failure] of `trial_fn` by batched Monte Carlo on `device`
    (CUDA unless the caller passes the CPU).

    trial_fn signatures:
      batched=False: trial_fn(generator) -> failed (a bool scalar), or
                     (failed, extras_dict): one trial a call, each on its
                     own derived generator (a Python loop; for the API and
                     the tests, not for a device's main path);
      batched=True:  trial_fn(generator, n) -> failed bool (n,), or
                     (failed, extras): a whole batch in one call (e.g. one
                     arena block a trial through the fused inject+scrub).

    Batch b runs on a generator seeded derive_seed(seed, b).  Each batch's
    failures and extras are summed on the device and fetched together in
    one transfer.  `seed` may be a `core.prng` key: batch b then takes
    ``fold_in(key, b)`` and its trials ``split`` of that (unbatched), the
    reference's draws.
    """
    dev = resolve_device(device)
    batch_fn = (lambda s, n: trial_fn(_generator(dev, s), n)) if batched \
        else _per_trial(trial_fn, dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    n = failures = 0
    extras_acc: Dict[str, float] = {}
    b = 0
    while n < cfg.max_trials:
        size = min(cfg.batch_size, cfg.max_trials - n)
        fail, extras = _normalize(batch_fn(child_seed(seed, b), size))
        b += 1
        if tuple(fail.shape) != (size,):
            raise ValueError(f"trial returned shape {tuple(fail.shape)}, "
                             f"expected ({size},)")
        sums = [fail.sum()] + [torch.as_tensor(v).sum()
                               for v in extras.values()]
        vals = torch.stack([s.to(device=fail.device, dtype=torch.float64)
                            for s in sums]).tolist()
        failures += int(vals[0])
        n += size
        for k2, v in zip(extras, vals[1:]):
            extras_acc[k2] = extras_acc.get(k2, 0.0) + v
        if cfg.ci_halfwidth > 0 and n >= cfg.min_trials:
            lo, hi = wilson_interval(failures, n, cfg.z)
            if (hi - lo) / 2.0 <= cfg.ci_halfwidth:
                break
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    return CampaignResult(name=name, n_trials=n, failures=failures,
                          z=cfg.z, extras=extras_acc, seconds=seconds,
                          peak_bytes=peak)


def _label(point: Mapping[str, Any]) -> str:
    return ",".join(f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in point.items())


def sweep(make_trial: Callable[..., Callable],
          points: Sequence[Mapping[str, Any]], seed: int,
          cfg: CampaignConfig = CampaignConfig(), *, batched: bool = False,
          device=None) -> List[Tuple[Mapping[str, Any], CampaignResult]]:
    """One campaign a grid point: make_trial(**point) builds the point's
    trial function, and point i runs under derive_seed(seed, i) (for a key,
    fold_in(key, i)), so points are independent and replayable one by
    one."""
    return [(pt, run_campaign(make_trial(**pt), child_seed(seed, i), cfg,
                              batched=batched, name=_label(pt),
                              device=device))
            for i, pt in enumerate(points)]


def sweep_schemes(make_trial: Callable, schemes: Sequence, seed: int,
                  cfg: CampaignConfig = CampaignConfig(), *,
                  batched: bool = False,
                  device=None) -> List[Tuple[Any, CampaignResult]]:
    """One campaign a protection scheme, labelled `scheme.name`: the one
    code path that walks the `repro_torch.reliability` design space.
    make_trial(scheme) builds the scheme's trial function; scheme i runs
    under derive_seed(seed, i) (for a key, fold_in(key, i))."""
    return [(scheme, run_campaign(make_trial(scheme), child_seed(seed, i),
                                  cfg, batched=batched, name=scheme.name,
                                  device=device))
            for i, scheme in enumerate(schemes)]
