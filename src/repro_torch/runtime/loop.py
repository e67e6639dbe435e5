"""Fault-tolerant training loop (port of `repro.runtime.loop`).

Composes the substrates: the train step, periodic checkpointing,
heartbeat/straggler monitoring, and the paper's reliability layer -- a
protection `Scheme` (`repro_torch.reliability`) verifying the parameter
store between steps under injected soft errors.

Redundancy is refreshed after every parameter write (for `DiagParityEcc`
one encode launch over the arena) and every `scrub_every` steps (or on the
`AdaptiveScrub` controller's schedule) `scheme.scrub` verifies and
corrects the store.  Each ScrubReport feeds the HeartbeatMonitor (an
uncorrectable block returns Decision.RESTART, which restores the latest
checkpoint) and a `core.analytics.ScrubTrajectory`.  `run()` survives
(simulated) preemptions by restoring the latest checkpoint and replaying
the data stream from the step counter.

Where the reference returns new arrays, the port holds ONE copy of the
parameters: after `attach_scheme` (and after every scrub and restore)
``state["params"]`` is the protected payload -- views of the scheme's
arena -- which the train step updates in place and `Scheme.refresh`
re-protects in place.  Injected faults are drawn from a `torch.Generator`
on the params' device, seeded with ``derive_seed(inject_seed + step,
total_restores)`` for transient models and with `inject_seed` for
permanent ones: the reference's key discipline, with other bits.  With
``inject_keyed`` they are the reference's own draws: `core.prng` keys
``PRNGKey(inject_seed)`` (permanent) or ``fold_in(PRNGKey(inject_seed +
step), total_restores)``, on the params' device.  Scrub telemetry performs ONE host fetch per scrub (the
counter triple); an optional `eval_fn` hook (e.g.
`launch.engine.make_eval_hook`) fires every `eval_every` steps on the
post-scrub params, its results kept on the device in `eval_history`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..core import arena, prng
from ..core import tree as T
from ..core.analytics import ScrubTrajectory
from ..core.seeds import derive_seed
from ..faults.models import FaultModel, TransientBitFlips
from ..obs import NULL_TRACER, DriftDetector, ScrubMetrics, Tracer
from ..reliability.scheme import (ArenaEcc, Compose, DiagParityEcc,
                                  Protected, Scheme, Tmr, parse_scheme)
from .adaptive import AdaptiveScrub
from .monitor import Decision, HeartbeatMonitor

__all__ = ["LoopConfig", "TrainLoop"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    scrub_every: int = 0          # 0 = scheme scrubbing disabled
    log_every: int = 10
    eval_every: int = 0           # 0 = eval hook disabled; else the loop's
                                  # eval_fn fires every this many steps
    inject_p_bit: float = 0.0     # simulated soft-error rate per scrub interval
    inject_seed: int = 0
    inject_keyed: bool = False    # draw the reference's faults from a
                                  # core.prng key (`_inject_key`) instead
                                  # of the generator's sparse sampler
    fault_model: Optional[FaultModel] = None  # overrides inject_p_bit: any
                                  # repro_torch.faults model drives injection
    scheme: Optional[Scheme] = None  # protection scheme; None ->
                                  # DiagParityEcc() on attach_scheme()
    max_scrub_restores: int = 3   # consecutive scheme restores before giving up
                                  # and continuing with best-effort correction
    adaptive_scrub: Any = None    # pay-as-you-fault cadence: an
                                  # AdaptiveScrub instance, or True to build
                                  # one from the injection prior on
                                  # attach_scheme(); overrides scrub_every


def _sync(metrics: Dict[str, Any]) -> None:
    """Wait for the step's device work (the reference's
    block_until_ready)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


class TrainLoop:
    def __init__(self, train_step: Callable, state: Any,
                 batch_at: Callable[[int], Any], cfg: LoopConfig,
                 ckpt: Optional[Checkpointer] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 log: Callable[[str], None] = print,
                 inject_fn: Optional[Callable[[Any, int], Any]] = None,
                 eval_fn: Optional[Callable[[Any, int], Any]] = None,
                 tracer: Tracer = NULL_TRACER):
        self.train_step = train_step
        self.state = state
        self.batch_at = batch_at
        self.cfg = cfg
        self.ckpt = ckpt
        self.monitor = monitor or HeartbeatMonitor()
        self.log = log
        self.step = 0
        self.scheme: Optional[Scheme] = None         # active protection scheme
        self.protected: Optional[Protected] = None   # scheme-wrapped params
        self.inject_fn = inject_fn    # deterministic corruptor hook (tests)
        self.eval_fn = eval_fn        # e.g. launch.engine.make_eval_hook
        self.tracer = tracer          # obs.Tracer: launch spans + heartbeat
                                      # events (NULL_TRACER = zero overhead)
        self.metrics_history: list = []
        self.eval_history: list = []
        self.scrub_reports: list = []
        self.scrub_trajectory = ScrubTrajectory()
        self.adaptive: Optional[AdaptiveScrub] = None
        self.total_restores = 0
        self._consecutive_scrub_restores = 0

    # -- reliability hooks -----------------------------------------------------
    # Protocol (paper §IV adapted): redundancy is refreshed after every
    # parameter write (the optimizer step == the mMPU "function output");
    # scrubbing verifies/corrects accumulated storage flips between
    # refreshes.
    @property
    def parity(self):
        if self.protected is not None and self.scheme.checkpoint_redundancy:
            return self.protected.redundancy
        return None

    def _default_scheme(self) -> Scheme:
        if self.cfg.scheme is not None:
            return self.cfg.scheme
        return DiagParityEcc()

    def _arm(self, prot: Protected) -> None:
        """Hold `prot`; the state's params become its payload (one copy)."""
        self.protected = prot
        self.state = dict(self.state, params=prot.payload)

    def attach_scheme(self, scheme: Optional[Scheme] = None) -> None:
        """Arm the protection scheme over the current parameter store.

        When the loop injects transient flips at a known `p_bit` and the
        scheme carries ECC, a `obs.DriftDetector` is armed on the monitor:
        observed correction rates vs the closed-form expectation become a
        health signal in `monitor.summary()["drift"]`."""
        self.scheme = scheme or self._default_scheme()
        self._arm(self.scheme.protect(self.state["params"]))
        self.scrub_trajectory.n_blocks = self._n_blocks()
        model = self._resolved_model()
        p_bit = getattr(model, "p_bit", None)
        if p_bit and not getattr(model, "permanent", False) \
                and self.monitor.drift is None \
                and isinstance(self.scheme, (ArenaEcc, Compose)):
            # Compose scrubs three independently corrupted copies per
            # interval, so the expected event stream is 3x one arena's
            copies = 3 if isinstance(self.scheme, Compose) else 1
            self.monitor.drift = DriftDetector(
                p_bit, self._n_blocks() * copies)
        if self.cfg.adaptive_scrub and self.adaptive is None:
            if isinstance(self.cfg.adaptive_scrub, AdaptiveScrub):
                self.adaptive = self.cfg.adaptive_scrub
            else:
                # prior-seeded controller: the injection rate (if known)
                # sizes interval0; the monitor's drift detector (if armed
                # above) vetoes relaxation while corrections run hot
                copies = 3 if isinstance(self.scheme,
                                         (Tmr, Compose)) else 1
                self.adaptive = AdaptiveScrub.from_prior(
                    p_bit or 0.0, self._n_blocks() * copies,
                    detector=self.monitor.drift,
                    # record_scrub already feeds the shared detector
                    feed_detector=False,
                    interval0=max(1, self.cfg.scrub_every or 32))

    def _n_blocks(self) -> int:
        return arena.arena_spec(self.state["params"]).n_blocks

    def _refresh(self) -> None:
        if self.protected is not None:
            self._arm(self.scheme.refresh(self.state["params"],
                                          self.protected))

    def _device(self) -> torch.device:
        return T.leaves(self.state["params"])[0].device

    def _inject_generator(self, model: FaultModel) -> torch.Generator:
        if model.permanent:
            # defect maps are device properties: one stable seed for the
            # whole run, or the "permanent" faults would relocate every
            # scrub interval (and survive restores, correctly)
            seed = self.cfg.inject_seed
        else:
            # fold the restore count in: real soft errors do not replay,
            # so a post-restore replay of this step must draw fresh flips
            # (else an uncorrectable draw would recur and livelock the run)
            seed = derive_seed(self.cfg.inject_seed + self.step,
                               self.total_restores)
        return torch.Generator(device=self._device()).manual_seed(seed)

    def _inject_key(self, model: FaultModel) -> torch.Tensor:
        """The reference's `_inject_key`: a stable key for a permanent
        model, else the step's key with the restore count folded in."""
        if model.permanent:
            return prng.key(self.cfg.inject_seed, self._device())
        return prng.fold_in(prng.key(self.cfg.inject_seed + self.step,
                                     self._device()), self.total_restores)

    def _resolved_model(self) -> Optional[FaultModel]:
        model = self.cfg.fault_model
        if model is None and self.cfg.inject_p_bit > 0:
            model = TransientBitFlips(self.cfg.inject_p_bit)
        return model

    def _corrupted_store(self) -> Protected:
        """The protected store after this interval's simulated exposure."""
        params = self.state["params"]
        if self.inject_fn is not None:
            # deterministic test hook: corrupts the payload copy only (in
            # place, returning `params`, or as a new tree)
            corrupted = self.inject_fn(params, self.step)
            if corrupted is params:
                return self.protected
            return self.scheme.adopt(corrupted, self.protected.redundancy)
        model = self._resolved_model()
        if model is None:
            return self.protected
        # corrupt EVERY held data copy, in place (copy-based schemes draw
        # each copy's faults in turn from the generator, so TMR double
        # faults and uncorrectable words are reachable); dt=1: one model
        # time unit == one scrub interval
        source = self._inject_key(model) if self.cfg.inject_keyed \
            else self._inject_generator(model)
        return self.scheme.corrupt_store(self.protected, model, source,
                                         dt=1.0)

    def _scrub(self) -> bool:
        """One scheme scrub pass; returns True if a restore rolled back the
        step counter (the caller must not finish the current iteration)."""
        with self.tracer.trace("scrub", step=self.step,
                               scheme=self.scheme.name):
            fixed, report = self.scheme.scrub(self._corrupted_store())
            self.scrub_reports.append((self.step, report))
            # ONE host fetch per scrub interval (the counter triple and
            # the scheme's vote share): the monitor's restore decision
            # needs the counts on the host, and everything downstream
            # reuses the same fetched values
            counters = [report.corrected, report.parity_fixed,
                        report.uncorrectable]
            vote = self.scheme.vote_share(report)
            corrected, parity_fixed, uncorrectable, *vote = torch.stack(
                counters + ([] if vote is None else [vote])).tolist()
        self.scrub_trajectory.add(self.step, corrected, parity_fixed,
                                  uncorrectable)
        if self.adaptive is not None:
            # the controller reuses the same fetched triple (no extra
            # sync); it reschedules the next scrub from these counts
            self.adaptive.record(self.step, corrected, uncorrectable,
                                 parity_fixed)
        injected = int(self.inject_fn is not None
                       or self._resolved_model() is not None)
        record = ScrubMetrics(
            corrected=corrected, parity_fixed=parity_fixed,
            uncorrectable=uncorrectable, injected=injected,
            vote_disagreements=vote[0] if vote else 0)
        decision = self.monitor.record_scrub(record)
        self.tracer.metrics({"step": self.step, "scheme": self.scheme.name,
                             "corrected": corrected,
                             "parity_fixed": parity_fixed,
                             "uncorrectable": uncorrectable,
                             "vote_disagreements":
                             record.vote_disagreements,
                             "decision": decision}, kind="scrub")
        if decision == Decision.RESTART and self.ckpt is not None \
                and self.ckpt.latest_step() is not None:
            if self._consecutive_scrub_restores < self.cfg.max_scrub_restores:
                self._consecutive_scrub_restores += 1
                self.log(f"[reliability] step {self.step}: "
                         f"{uncorrectable} uncorrectable blocks -> restore")
                return self.restore()
            # the same replay window keeps producing uncorrectable blocks:
            # restoring again cannot help, so accept the best-effort
            # correction and keep training rather than livelock
            self.log(f"[reliability] step {self.step}: restore limit "
                     f"({self.cfg.max_scrub_restores}) reached; continuing "
                     f"with best-effort corrected params")
        else:
            self._consecutive_scrub_restores = 0
        self._arm(fixed)
        return False

    # -- checkpoint/restore ------------------------------------------------------
    def save(self) -> None:
        if self.ckpt is not None:
            snap = {"state": self.state, "step": self.step}
            if self.protected is not None:
                # scheme-name marker: lets a fresh process re-arm copy-based
                # schemes whose redundancy is rebuilt from params (no parity
                # table to detect them by)
                snap["scheme"] = self.scheme.name
            parity = self.parity
            if parity is not None:
                snap["parity"] = parity
            self.ckpt.save(self.step, snap)

    def restore(self) -> bool:
        if self.ckpt is None:
            return False
        # an async re-save may be mid-rename on the dir we are about to
        # read; drain it before resolving snapshots
        self.ckpt.wait()
        if self.ckpt.latest_step() is None:
            return False
        self.tracer.instant("restore", step=self.step)
        device = self._device()
        armed = self.protected is not None
        # drop the current store before the snapshot lands on the device
        self.protected = None
        snap = self.ckpt.restore_tensors(device="cpu")
        state = dict(snap["state"])
        self.state = {}
        # the params into one arena, packed on the host, moved once
        words, spec = arena.pack(state.pop("params"))
        params = arena.unpack(words.to(device), spec)
        self.state = dict(T.map_tree(lambda x: x.to(device), state),
                          params=params)
        self.total_restores += 1
        if "parity" in snap:
            # a parity table in the snapshot means the saving run had an ECC
            # scheme attached -- re-arm it even in a fresh process (scheme
            # is None), or scrubbing would silently stop across preemption
            # restarts.  A per-leaf parity tree (a legacy layout) is not
            # the (n_blocks, F) table: re-encode from the params.
            self.scheme = self.scheme or self._default_scheme()
            parity = snap["parity"]
            if not self.scheme.checkpoint_redundancy:
                # the snapshot came from an ECC run but this loop runs a
                # copy-based scheme: the parity table simply doesn't apply
                self.log(f"[restore] snapshot parity ignored (current "
                         f"scheme {self.scheme.name} rebuilds redundancy "
                         f"from params)")
                self._arm(self.scheme.protect(params))
            elif isinstance(parity, torch.Tensor) and parity.ndim == 2:
                self._arm(self.scheme.adopt(params, parity.to(device)))
            else:
                self.log("[restore] legacy/unknown parity layout in "
                         "snapshot; re-protecting from restored params")
                self._arm(self.scheme.protect(params))
            self.scrub_trajectory.n_blocks = self._n_blocks()
        elif armed:
            self._arm(self.scheme.refresh(params))
        elif "scheme" in snap:
            # the saving run had a copy-based scheme armed (no parity table
            # in the snapshot) -- re-arm it in this fresh process, or
            # scrubbing would silently stop across preemption restarts
            name = str(np.asarray(snap["scheme"]).item())
            self.scheme = self.scheme or self.cfg.scheme \
                or parse_scheme(name)
            self.log(f"[restore] re-armed protection scheme "
                     f"{self.scheme.name} (snapshot ran {name})")
            self._arm(self.scheme.protect(params))
            self.scrub_trajectory.n_blocks = self._n_blocks()
        self.step = int(snap["step"])
        self.log(f"[restore] resumed from step {self.step}")
        return True

    # -- main loop ----------------------------------------------------------------
    def run(self, fail_at: Optional[int] = None) -> Dict:
        """Run to total_steps.  fail_at simulates a preemption at that step
        (raises, caller re-invokes run(); state restores from checkpoint)."""
        c = self.cfg
        while self.step < c.total_steps:
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"simulated preemption at step {self.step}")
            t0 = time.perf_counter()
            with self.tracer.trace("train_step", step=self.step):
                batch = self.batch_at(self.step)
                self.state, metrics = self.train_step(self.state, batch)
                _sync(metrics)
            dt = time.perf_counter() - t0
            decision = self.monitor.record_step(dt)
            self.step += 1
            if c.log_every and self.step % c.log_every == 0:
                loss = float(metrics.get("loss", metrics.get("total",
                                                             np.nan)))
                self.log(f"step {self.step:5d} loss {loss:.4f} ({dt:.3f}s)")
                self.metrics_history.append((self.step, loss))
                # heartbeat as a structured event: step timing + monitor
                # state, one JSONL record / counter track per log interval
                self.tracer.metrics(
                    {"step": self.step, "loss": loss, "step_s": dt,
                     **{k: v for k, v in self.monitor.summary().items()
                        if not isinstance(v, dict)}}, kind="heartbeat")
                self.tracer.counter("step_s", dt)
            if self.protected is not None:
                self._refresh()
                due = (self.adaptive.due(self.step)
                       if self.adaptive is not None
                       else c.scrub_every
                       and self.step % c.scrub_every == 0)
                if due:
                    if self._scrub():
                        continue   # restored: step rolled back, re-enter loop
            if self.eval_fn is not None and c.eval_every \
                    and self.step % c.eval_every == 0:
                # post-scrub, so the store the eval sees is the corrected
                # one; results stay on device (fetch after training)
                with self.tracer.trace("eval", step=self.step):
                    self.eval_history.append(
                        self.eval_fn(self.state["params"], self.step))
            if (c.checkpoint_every and self.step % c.checkpoint_every == 0) \
                    or decision == Decision.CHECKPOINT_NOW:
                with self.tracer.trace("checkpoint", step=self.step):
                    self.save()
        if self.ckpt is not None:
            self.ckpt.wait()
        return {"final_step": self.step, "monitor": self.monitor.summary(),
                "scrub": self.scrub_trajectory.summary(c.inject_p_bit)}
