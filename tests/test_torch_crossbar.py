"""The port's crossbar simulator (`repro_torch.core.crossbar`) against the
JAX package's `repro.core.crossbar`.

At zero error, bit for bit: the state after every vectored gate (row,
column and partitioned, each gate of the FELIX set), writes and drift, and
the `CycleCounter`'s cycles and gate evaluations, over fixed and random
programs.  `ErrorModel` resolves the same default fault models.  With
faults the port draws from a `torch.Generator` (other bits than JAX's
keys): stuck-at input defects may only pin cells to their stuck value (a
gate reads the pinned inputs it wrote back), the pinned map replays from
the seed, and retention drift and gate faults flip a binomial share of
cells over 200 seeds (`_binomial`).  The
simulator runs on CUDA unless the caller passes a device."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _binomial import counts_over_seeds, fits_binomial
from repro.core import crossbar as jxb
from repro.faults import models as jm
from repro_torch.core.crossbar import Crossbar, ErrorModel
from repro_torch.core.stateful_logic import CycleCounter
from repro_torch.faults import (RetentionDrift, StuckAtFaults,
                                TransientBitFlips)

ROOT = os.path.join(os.path.dirname(__file__), "..")

GATES = {"not": 1, "nor": 2, "or": 2, "nand": 2, "and": 2, "min3": 3,
         "maj3": 3, "xor": 2}


def _state(rows, cols, seed):
    return np.random.default_rng(seed).random((rows, cols)) < 0.5


def _pair(a):
    return (jxb.Crossbar.from_array(a),
            Crossbar.from_array(torch.from_numpy(a), device="cpu"))


def _same(jx, px):
    np.testing.assert_array_equal(px.state.numpy(), np.asarray(jx.state))
    assert (px.counter.cycles, px.counter.gate_evals) == \
        (jx.counter.cycles, jx.counter.gate_evals)


@pytest.mark.parametrize("gate", sorted(GATES))
def test_row_and_col_gates_match_jax(gate):
    a = _state(24, 20, 1)
    jx, px = _pair(a)
    n = GATES[gate]
    jx = jx.row_gate(gate, list(range(3, 3 + n)), 17)
    px = px.row_gate(gate, list(range(3, 3 + n)), 17)
    _same(jx, px)
    jx = jx.col_gate(gate, list(range(n)), 23)
    px = px.col_gate(gate, list(range(n)), 23)
    _same(jx, px)
    # output overwriting one of its own inputs
    jx = jx.row_gate(gate, list(range(n)), 0)
    px = px.row_gate(gate, list(range(n)), 0)
    _same(jx, px)


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("part", [4, 8])
def test_partitioned_gates_match_jax(gate, part):
    a = _state(16, 32, 2)
    jx, px = _pair(a)
    n = GATES[gate]
    jx = jx.partitioned_row_gate(gate, part, list(range(n)), part - 1)
    px = px.partitioned_row_gate(gate, part, list(range(n)), part - 1)
    _same(jx, px)


@pytest.mark.parametrize("seed", range(4))
def test_random_program_matches_jax(seed):
    """A random sequence of gates, writes and zero-rate drift."""
    rng = np.random.default_rng(seed)
    rows, cols = 32, 48
    jx, px = _pair(_state(rows, cols, seed))
    key = jax.random.PRNGKey(seed)
    g = torch.Generator().manual_seed(seed)
    for _ in range(40):
        op = rng.integers(0, 6)
        gate = sorted(GATES)[rng.integers(0, len(GATES))]
        n = GATES[gate]
        if op == 0:
            ins = [int(c) for c in rng.choice(cols, n, replace=False)]
            out = int(rng.integers(0, cols))
            jx, px = jx.row_gate(gate, ins, out, key), \
                px.row_gate(gate, ins, out, g)
        elif op == 1:
            ins = [int(r) for r in rng.choice(rows, n, replace=False)]
            out = int(rng.integers(0, rows))
            jx, px = jx.col_gate(gate, ins, out, key), \
                px.col_gate(gate, ins, out, g)
        elif op == 2:
            ins = [int(o) for o in rng.choice(8, n, replace=False)]
            out = int(rng.integers(0, 8))
            jx = jx.partitioned_row_gate(gate, 8, ins, out, key)
            px = px.partitioned_row_gate(gate, 8, ins, out, g)
        elif op == 3:
            v = rng.random(rows) < 0.5
            c = int(rng.integers(0, cols))
            jx, px = jx.write_col(c, v), px.write_col(c, torch.from_numpy(v))
        elif op == 4:
            v = rng.random(cols) < 0.5
            r = int(rng.integers(0, rows))
            jx, px = jx.write_row(r, v, key, 0.0), \
                px.write_row(r, v, g, 0.0)
        else:
            jx, px = jx.drift(key, 3.0), px.drift(g, 3.0)
        _same(jx, px)
    assert px.counter.cycles > 0


def test_zeros_and_shapes_match_jax():
    jx = jxb.Crossbar.zeros(5, 7)
    px = Crossbar.zeros(5, 7, device="cpu")
    assert px.shape == tuple(jx.shape) == (5, 7)
    assert px.state.dtype == torch.bool and not px.state.any()
    _same(jx, px)


def test_error_model_defaults_match_jax():
    for kw in ({}, {"p_input": 1e-3, "p_retention": 2e-3, "p_gate": 1e-4}):
        j, p = jxb.ErrorModel(**kw), ErrorModel(**kw)
        assert j.gate_param() == p.gate_param()
        assert j.has_input_noise == p.has_input_noise
        assert isinstance(p.input_model(), TransientBitFlips)
        assert p.input_model().p_bit == j.input_model().p_bit
        assert isinstance(p.retention_model(), RetentionDrift)
        assert p.retention_model().p_unit == j.retention_model().p_unit
    p = ErrorModel(input=StuckAtFaults(1e-4, 1e-4))
    j = jxb.ErrorModel(input=jm.StuckAtFaults(1e-4, 1e-4))
    assert p.has_input_noise and j.has_input_noise
    assert p.input_model() is p.input


def test_cycle_counter_add():
    c = CycleCounter(3, 30) + CycleCounter(2, 5)
    assert (c.cycles, c.gate_evals) == (5, 35)


def test_the_simulator_is_functional():
    a = _state(8, 8, 3)
    x = Crossbar.from_array(torch.from_numpy(a), device="cpu")
    before = x.state.clone()
    y = x.row_gate("nor", [0, 1], 2).col_gate("not", [0], 7)
    y = y.partitioned_row_gate("or", 4, [0, 1], 3).write_col(5, [1] * 8)
    assert torch.equal(x.state, before) and not torch.equal(y.state, before)


# -- with faults: the port's own draws -----------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_stuck_input_defects_pin_cells(seed):
    """ErrorModel(input=StuckAtFaults): the gate's input columns may only
    move to their stuck values, the gate reads the pinned inputs (its
    output is NOR of the stored columns afterwards) and the same seed pins
    the same cells."""
    a = _state(4096, 4, seed)
    err = ErrorModel(input=StuckAtFaults(2e-3, 2e-3))
    x = Crossbar.from_array(torch.from_numpy(a), err, device="cpu")
    y = x.row_gate("nor", [0, 1], 2, torch.Generator().manual_seed(seed))
    z = x.row_gate("nor", [0, 1], 2, torch.Generator().manual_seed(seed))
    assert torch.equal(y.state, z.state)
    moved = y.state[:, :2] != x.state[:, :2]
    assert moved.any()
    assert torch.equal(y.state[:, 2], ~(y.state[:, 0] | y.state[:, 1]))
    assert torch.equal(y.state[:, 3], x.state[:, 3])
    # a second read under the same seed pins the same cells: no change
    again = y.row_gate("nor", [0, 1], 2, torch.Generator().manual_seed(seed))
    assert torch.equal(again.state, y.state)


def test_retention_drift_flips_a_binomial_share():
    n = 1024
    x = Crossbar.zeros(n, n, ErrorModel(p_retention=1e-4), device="cpu")
    fits_binomial(counts_over_seeds(lambda seed: int(x.drift(
        torch.Generator().manual_seed(seed), dt=4.0).state.sum())),
        n * n, RetentionDrift(1e-4)._rate(4.0))
    # a stuck-at retention model is idempotent under reseeding
    s = Crossbar.from_array(torch.from_numpy(_state(256, 256, 5)),
                            ErrorModel(retention=StuckAtFaults(1e-3, 1e-3)),
                            device="cpu")
    d1 = s.drift(torch.Generator().manual_seed(2))
    d2 = d1.drift(torch.Generator().manual_seed(2))
    assert torch.equal(d1.state, d2.state) and \
        not torch.equal(d1.state, s.state)


def test_gate_faults_flip_outputs():
    n = 1 << 14
    x = Crossbar.zeros(n, 3, ErrorModel(p_gate=0.01), device="cpu")
    fits_binomial(counts_over_seeds(lambda seed: int((~x.row_gate(
        "nor", [0, 1], 2, torch.Generator().manual_seed(seed)).state[:, 2])
        .sum())), n, 0.01)                       # NOR(0, 0) = 1
    assert torch.equal(x.row_gate("nor", [0, 1], 2).state[:, 2],
                       torch.ones(n, dtype=torch.bool))


def test_defaults_to_cuda_and_raises_without_a_gpu():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        import torch
        torch.cuda.is_available = lambda: False
        from repro_torch.core.crossbar import Crossbar
        for call in (lambda: Crossbar.zeros(4, 4),
                     lambda: Crossbar.from_array([[True]])):
            try:
                call()
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            else:
                raise AssertionError("ran without a GPU")
        Crossbar.zeros(4, 4, device="cpu")
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
