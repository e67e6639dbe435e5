"""What each rank of the dry run's test world runs
(`tests/test_torch_dryrun.py`): the training step of small configs on a
2x2 and then a 4x1 mesh of the same four gloo ranks, recording the
collectives each rank issues (`launch.mesh.collective_log`), the step's
FLOPs (`FlopCounterMode`) and the bytes of its state and batch.  It
imports torch and the port only, so a rank never pays for JAX.
"""
from __future__ import annotations

import torch


def train_cases(dev, cases):
    """{(config name, mesh shape): {"log", "flops", "arg_bytes"}} of one
    step of every case (name, cfg, K, batch, seq) on each mesh."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import DEFAULT_TRAIN_POLICY
    from repro_torch.launch.dryrun import storage_bytes
    from repro_torch.launch.mesh import collective_log, make_test_mesh
    from repro_torch.launch.shards import plan_for
    from repro_torch.launch.specs import train_state
    from repro_torch.models.params import materialize
    from repro_torch.models.steps import make_train_step
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.pshard import DEFAULT_RULES, use_mesh_and_rules
    policy = dict(DEFAULT_TRAIN_POLICY)
    out = {}
    for shape in ((2, 2), (4, 1)):
        mesh = make_test_mesh(*shape, device=dev)
        for name, cfg, K, B, S in cases:
            g = torch.Generator().manual_seed(0)
            params = materialize(model_specs(cfg), g)
            state = train_state(params, cfg, mesh, DEFAULT_RULES, policy, dev)
            batch = {"tokens": torch.randint(0, cfg.vocab, (B, S),
                                             dtype=torch.int32, generator=g)}
            step = make_train_step(
                cfg, AdamWConfig(), microbatches=K,
                param_pspecs=plan_for(cfg, mesh, DEFAULT_RULES).pspecs)
            arg_bytes = storage_bytes((state, batch))
            with use_mesh_and_rules(mesh, DEFAULT_RULES), \
                    collective_log() as log, \
                    FlopCounterMode(display=False) as flops:
                step(state, batch)
            out[(name, shape)] = {"log": list(log), "arg_bytes": arg_bytes,
                                  "flops": flops.get_total_flops()}
    return out
