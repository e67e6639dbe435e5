"""Trace-driven mMPU cost model (port of `repro.costmodel`).

Compiles the repo's two workload IRs — levelized netlist schedules and
per-`Scheme` generation/train steps — into typed :class:`MmpuEvent`
streams, then folds them into MAGIC/FELIX cycle counts, switching
energy, and cycles/energy per token under a :class:`DeviceSpec`.

    from repro_torch import costmodel
    from repro_torch.configs.mmpu_paper import get_device

    spec = get_device("paper")
    profile = costmodel.StepProfile.from_model_config(cfg, batch=8)
    costs = costmodel.evaluate_grid(standard_grid(), profile, spec,
                                    device="cuda")

Streams, their JSONL text and the integer fields are the reference's; the
folds run in float64 torch (`evaluate`).
"""
from .device import DeviceSpec, EVENT_KINDS, KIND_INDEX, spec_from_dict
from .events import (EventArrays, MmpuEvent, dump_jsonl, load_jsonl,
                     scale_stream, stack_streams)
from .compile import (StepProfile, base_step_events, ecc_events,
                      lower_schedule, lower_step, mac_kernel_events,
                      secded_events, tmr_transform, vote_events)
from .evaluate import MmpuCost, evaluate_grid, fold, fold_arrays, project_macs

__all__ = [
    "DeviceSpec", "EVENT_KINDS", "KIND_INDEX", "spec_from_dict",
    "MmpuEvent", "EventArrays", "dump_jsonl", "load_jsonl", "scale_stream",
    "stack_streams",
    "StepProfile", "lower_schedule", "lower_step", "base_step_events",
    "ecc_events", "secded_events", "tmr_transform", "vote_events",
    "mac_kernel_events",
    "MmpuCost", "fold", "fold_arrays", "evaluate_grid", "project_macs",
]
