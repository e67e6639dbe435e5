"""What each rank of the tensor-parallel test worlds runs
(`tests/test_torch_tensor_parallel.py`): a serving engine on a (data,
model) mesh that computes heads, ff and vocab where they live.

`launch.mesh.spawn` starts these in fresh processes, which import this
module by name: it imports torch and the port only.  Each returns host
values for the test process to check.
"""
from __future__ import annotations

import numpy as np
import torch

#: the engine's scheme and weight fault rate (ECC corrects every flip)
SCHEME, P_BIT = "ecc", 1e-6


def engine_run(eng, params, tokens, gen: int, key: int):
    """`eng.prepare` from numpy `params` under `SCHEME` with flips drawn
    from ``prng.key(key)``, then: the generate's tokens and counters and
    the leaves it read (`placement.LeafReads`); the whole first-step and
    teacher-forced decode logits (the generated tokens fed back, through
    the engine's batch split and view); and the residual stream after
    every layer of that prefill."""
    from repro_torch.core import prng
    from repro_torch.faults import TransientBitFlips
    from repro_torch.launch.engine import fetch_telemetry
    from repro_torch.launch.placement import LeafReads
    from repro_torch.models import transformer as PT
    from repro_torch.models.params import from_numpy
    from repro_torch.models.steps import make_decode_step
    batch = {"tokens": torch.from_numpy(tokens)}
    store, prep = eng.prepare(from_numpy(params),
                              generator=prng.key(key, "cpu"),
                              fault=TransientBitFlips(P_BIT))
    with LeafReads() as reads:
        toks, tel = eng.generate(store, batch)
    stream = []
    res = {"mlp": PT._mlp_res, "moe": PT._moe_res}

    def recorded(name):
        def f(*args):
            out = res[name](*args)
            stream.append((out[0] if name == "moe" else out).numpy().copy())
            return out
        return f

    b, rows = eng._split(eng._batch(batch), store)
    prefill, _ = eng._steps(b["tokens"].shape[1])
    decode = make_decode_step(eng.cfg)
    logits = []
    PT._mlp_res, PT._moe_res = recorded("mlp"), recorded("moe")
    try:
        with torch.no_grad(), eng._ambient(store, rows):
            params_view = eng._params(store)
            _, lg, cache = prefill(params_view, b)
            logits.append(lg)
            mine = toks if rows is None else toks[rows[1]]
            for i in range(gen - 1):
                _, lg, cache = decode(params_view, mine[:, i:i + 1], cache)
                logits.append(lg)
    finally:
        PT._mlp_res, PT._moe_res = res["mlp"], res["moe"]
    logits = torch.stack([eng._join(store, rows, x, {})[0] for x in logits])
    return {"tokens": toks.numpy().copy(),
            "stats": {k: np.asarray(v) for k, v in
                      fetch_telemetry({**prep, **tel}).items()},
            "logits": logits.numpy().copy(),
            "stream": stream[:eng.cfg.n_layers],
            "reads": [(store.global_spec.paths[li], shape, largest)
                      for li, shape, largest in reads.reads]}


def tensor_parallel(mesh, cases):
    """Per case (name, cfg, rules overrides, params as numpy, tokens
    (B, S), gen, fault key): `engine_run` on `mesh`."""
    from repro_torch.launch.engine import GenerationEngine
    from repro_torch.pshard import DEFAULT_RULES
    from repro_torch.reliability import parse_scheme
    out = {}
    for name, cfg, overrides, params, tokens, gen, key in cases:
        eng = GenerationEngine(cfg, parse_scheme(SCHEME), gen=gen,
                               device="cpu", mesh=mesh,
                               rules=DEFAULT_RULES.replace(**overrides))
        out[name] = engine_run(eng, params, tokens, gen, key)
    return out


def exchanges(mesh, seed):
    """The model group's exchanges on small integer-valued inputs (every
    product and sum exact in fp32): a column-parallel ``[u | g]`` and
    ``[k | v]`` product re-aligned (`pshard.realign`) against the whole
    product's matching columns; `pshard.vocab_greedy` against
    `torch.argmax` of the whole row on rows with ties within and across
    ranks, the largest in the last (padded) columns, NaNs; and the
    ordered sum's bits on every rank.  Returns what each check found."""
    from repro_torch import pshard as P
    from repro_torch.pshard import (DEFAULT_RULES, model_columns, model_sum,
                                    realign, use_mesh_and_rules,
                                    vocab_greedy)
    axes = ("model",)
    n, k = mesh.shape["model"], mesh.coords["model"]
    g = torch.Generator().manual_seed(seed)
    out = {}
    with use_mesh_and_rules(mesh, DEFAULT_RULES):
        x = torch.randint(-3, 4, (2, 5, 16), generator=g).float()
        for name, width in (("ug", 24), ("kv", 16)):
            w = torch.randint(-3, 4, (16, 2 * width), generator=g).float()
            cols = 2 * width // n
            got = realign(x @ w[:, k * cols:(k + 1) * cols], axes, 2)
            whole = x @ w
            part = width // n
            want = torch.cat([whole[..., k * part:(k + 1) * part],
                              whole[..., width + k * part:
                                    width + (k + 1) * part]], dim=-1)
            out[name] = bool(torch.equal(got, want)) and got.is_contiguous()
        V = 12 * n
        rows = torch.randint(-5, 5, (7, V), generator=g).float()
        rows[0, 3] = rows[0, V - 3] = 9.0            # a tie across ranks
        rows[1, 1] = rows[1, 2] = 9.0                # a tie within a rank
        rows[2, V - 1] = 9.0                         # the last column
        rows[3, V - 2:] = 9.0                        # the last two
        rows[4, 5] = float("nan")                    # a NaN wins
        rows[5, V - 4] = float("nan")
        rows[5, V - 1] = float("nan")                # the first NaN wins
        rows[6, :] = 1.0                             # all equal
        w = V // n
        got = vocab_greedy(rows[:, k * w:(k + 1) * w], axes)
        out["greedy"] = (got.numpy().copy(),
                         torch.argmax(rows, dim=-1).to(torch.int32).numpy())
        # fp32 parts of unlike scales: another order would round otherwise
        y = torch.randn((4, 64), generator=g) * 10.0 ** k
        out["sum"] = model_sum(y, axes).view(torch.int32).numpy().copy()
        out["sum_bf16"] = model_sum(y.to(torch.bfloat16), axes).view(
            torch.int16).numpy().copy()
        # row chunks (a long prefill's) give the same bits as one exchange
        z = torch.randn((3, 5, 2 * n * 4), generator=g)
        whole = [model_sum(z, axes), realign(z, axes, 2),
                 model_columns(z, axes)]
        old, P.PART_BYTES = P.PART_BYTES, 4 * z.shape[-1] * 2
        try:
            chunked = [model_sum(z, axes), realign(z, axes, 2),
                       model_columns(z, axes)]
        finally:
            P.PART_BYTES = old
        out["chunked"] = all(torch.equal(a, b)
                             for a, b in zip(whole, chunked))
    return out
