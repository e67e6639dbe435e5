"""The port's training entry point (`repro_torch.launch.train`) and the
slice as a whole.

* ``python -m repro_torch.launch.train --device cpu --smoke --steps 4``
  runs in-process (and with the scrub engine, injection and a
  checkpoint; `--resume` picks the snapshot up);
* `build(cfg=)` takes a config cut in depth;
* the whole loop on the phi3-mini smoke config (4 layers, d_model 128,
  float32 compute) against the JAX package's `TrainLoop` from one numpy
  state (weights at std 0.02, see `tests/test_torch_steps.py`) under
  `ecc`, 4 steps, a scrub every 2 with the same planted flips: every
  scrub's counters and the monitor's scrub fields equal the reference's,
  the parity after the last refresh equals the reference's encode of the
  port's params bit for bit, the losses within rtol 1e-5, the params
  within rtol 1e-5 (atol 1e-5 of each leaf's largest value), and the eval
  hook's tokens equal `GenerationEngine.generate` on the final params.
  Adam divides an element's momentum by its root mean square, so an
  element whose grads are near zero moves by up to lr however small they
  are, and there the two frameworks' rounding shows: at most 1e-4 of the
  params may miss the tolerance, by at most 1% of lr x steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.steps import init_train_state as j_init_state
from repro.models.steps import make_train_step as j_train_step
from repro.optim import AdamWConfig as JAdamWConfig
from repro.reliability import parse_scheme as j_parse
from repro.runtime import LoopConfig as JLoopConfig
from repro.runtime import TrainLoop as JTrainLoop
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.engine import GenerationEngine, make_eval_hook
from repro_torch.models.params import train_state_from_reference
from repro_torch.models.steps import make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.reliability import parse_scheme
from repro_torch.runtime import LoopConfig, TrainLoop
from test_torch_steps import SMOKE, smoke_params


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_runs_in_process(capsys):
    summary = train.main(["--device", "cpu", "--smoke", "--steps", "4"])
    assert summary["final_step"] == 4
    assert "[train] done" in capsys.readouterr().out


def test_cli_scrubs_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--smoke", "--batch", "2", "--seq", "32",
            "--ecc-scrub-every", "2", "--inject-p-bit", "1e-6",
            "--ckpt-dir", str(tmp_path), "--checkpoint-every", "2",
            "--scheme", "hsiao", "--microbatches", "2",
            "--grad-compression", "--log-every", "1",
            "--metrics", str(tmp_path / "m.jsonl")]
    out = train.main(args + ["--steps", "4"])
    assert out["monitor"]["scrubs"] == 2
    assert out["monitor"]["bits_corrected"] > 0
    assert out["monitor"]["uncorrectable"] == 0
    assert (tmp_path / "m.jsonl").exists()
    out = train.main(args + ["--steps", "6", "--resume"])
    assert out["final_step"] == 6
    assert "[restore] resumed from step 4" in capsys.readouterr().out


def test_build_takes_a_cut_config():
    args = train.parser().parse_args(["--device", "cpu", "--steps", "2",
                                      "--ecc-scrub-every", "1",
                                      "--scheme", "ecc+tmr-parallel"])
    cfg = get_config("phi3-mini-3.8b").smoke().replace(n_layers=1)
    cfg, loop, n_params = train.build(args, cfg=cfg)
    assert cfg.n_layers == 1 and cfg.compute_dtype == "float32"
    assert loop.scheme.name == "ecc+tmr-parallel"
    assert T.leaves(loop.state["params"])[0].shape[0] in (1, cfg.padded_vocab,
                                                         cfg.d_model)
    # one copy of the params: the state's leaves are copy 0 of the arena
    assert loop.protected.payload is loop.state["params"]
    assert n_params == sum(x.numel() for x in T.leaves(loop.state["params"]))


def test_train_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])


#: step -> (word, bit) flips planted in both loops' params
PLANTS = {2: [(7, 11)], 4: [(4000, 3), (90000, 30)]}


def test_loop_matches_reference():
    jcfg = jax_config("phi3-mini-3.8b").smoke().replace(**SMOKE)
    cfg = get_config("phi3-mini-3.8b").smoke().replace(**SMOKE)
    params = smoke_params(jcfg, seed=4)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch_per_rank=4, seed=0)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=4, clip_norm=1e3)

    def j_inject(p, step):
        if step not in PLANTS:
            return p
        w = p["layers"]["mlp"]["w_up"]
        u = jax.lax.bitcast_convert_type(w, jnp.uint32).reshape(-1)
        for idx, bit in PLANTS[step]:
            u = u.at[idx].set(u[idx] ^ jnp.uint32(1 << bit))
        return jax.tree.map(lambda x: x, dict(p, layers=dict(
            p["layers"], mlp=dict(p["layers"]["mlp"], w_up=jax.lax.
                                  bitcast_convert_type(u, jnp.float32)
                                  .reshape(w.shape)))))

    def inject(p, step):
        if step in PLANTS:       # in place, in the arena the scheme holds
            u = p["layers"]["mlp"]["w_up"].view(torch.int32).view(-1)
            for idx, bit in PLANTS[step]:
                u[idx] ^= 1 << bit
        return p

    jstate = j_init_state(jax.tree.map(jnp.asarray, params))
    ref = JTrainLoop(jax.jit(j_train_step(jcfg, JAdamWConfig(**opt))), jstate,
                     lambda s: {"tokens": jnp.asarray(data.batch_at(s))},
                     JLoopConfig(total_steps=4, checkpoint_every=0,
                                 scrub_every=2, log_every=1,
                                 scheme=j_parse("ecc")),
                     inject_fn=j_inject, log=lambda *_: None)
    ref.attach_scheme()
    jout = ref.run()

    engine = GenerationEngine(cfg, gen=4, device="cpu")
    prompt = {"tokens": torch.from_numpy(data.batch_at(99)[:2, :8])}
    state = train_state_from_reference(jax.tree.map(np.asarray, jstate))
    loop = TrainLoop(make_train_step(cfg, AdamWConfig(**opt)), state,
                     lambda s: {"tokens": torch.from_numpy(data.batch_at(s))},
                     LoopConfig(total_steps=4, checkpoint_every=0,
                                scrub_every=2, log_every=1, eval_every=4,
                                scheme=parse_scheme("ecc")),
                     inject_fn=inject, eval_fn=make_eval_hook(engine, prompt),
                     log=lambda *_: None)
    loop.attach_scheme()
    out = loop.run()

    got = [tuple(int(v) for v in r) for _, r in loop.scrub_reports]
    want = [tuple(int(v) for v in r) for _, r in ref.scrub_reports]
    assert got == want == [(1, 0, 0), (2, 0, 0)]
    assert out["scrub"] == jout["scrub"]
    for k in ("scrubs", "bits_corrected", "uncorrectable"):
        assert out["monitor"][k] == jout["monitor"][k]
    np.testing.assert_allclose([l for _, l in loop.metrics_history],
                               [l for _, l in ref.metrics_history], rtol=1e-5)
    fresh = j_parse("ecc").protect(jax.tree.map(
        jnp.asarray, T.map_tree(lambda x: x.numpy(), loop.state["params"])))
    np.testing.assert_array_equal(loop.parity.numpy().view(np.uint32),
                                  np.asarray(fresh.redundancy))
    n_off = n_all = 0
    for a, b in zip(T.leaves(loop.state["params"]),
                    jax.tree.leaves(ref.state["params"])):
        a, b = a.numpy(), np.asarray(b)
        n_off += (~np.isclose(a, b, rtol=1e-5,
                              atol=1e-5 * np.abs(b).max())).sum()
        n_all += a.size
        assert np.abs(a - b).max() <= 0.01 * opt["lr"] * 4
    assert n_off <= 1e-4 * n_all
    (hook,) = loop.eval_history
    tokens, _ = engine.generate(loop.state["params"], prompt)
    assert hook["step"] == 4 and torch.equal(hook["tokens"], tokens)
