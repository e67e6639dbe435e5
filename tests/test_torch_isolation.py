"""The port stands alone: `repro_torch` and `chip_smoke.py` import without
JAX or the JAX package, and its entry points refuse to fall back to the
CPU when no GPU is present and the caller did not ask for the CPU."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.join(os.path.dirname(__file__), "..")

BLOCKED = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None          # any import of them now fails
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {root!r})
    import repro_torch
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    for m in mods:
        importlib.import_module(m)
    import chip_smoke                     # imported, not run
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")
              and sys.modules[m] is not None]
    assert not leaked, leaked
    print(len(mods), "modules:", " ".join(sorted(mods)))
""")

NO_GPU = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    import torch
    torch.cuda.is_available = lambda: False     # a machine with no GPU
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.launch.batching import (BatchSpec, ContinuousBatcher,
                                             PagedKVPool)
    from repro_torch.launch.engine import GenerationEngine
    cfg = get_config("phi3-mini-3.8b").smoke()
    spec = BatchSpec(slots=1, page_tokens=4, chunk=2, prompt_buckets=(4,),
                     gen_cap=4)
    for call in (lambda: GenerationEngine(cfg, gen=1),
                 lambda: GenerationEngine(cfg, gen=1, device="cuda"),
                 lambda: ContinuousBatcher(cfg),
                 lambda: ContinuousBatcher(cfg, device="cuda"),
                 lambda: PagedKVPool(cfg, spec, copies=False),
                 lambda: serve.main(["--smoke", "--gen", "1"]),
                 lambda: serve.main(["--server", "--smoke", "--gen", "2",
                                     "--requests", "1"]),
                 lambda: train.main(["--smoke", "--steps", "1"])):
        try:
            call()
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError("ran without a GPU")
    from repro_torch.core import tmr
    from repro_torch.experiments import campaign_mc, fig4_nn, fig5_weights
    from repro_torch.faults import run_campaign
    for call in (lambda: campaign_mc.run(smoke=True),
                 lambda: fig4_nn.run(smoke=True),
                 lambda: fig5_weights.run(smoke=True),
                 lambda: campaign_mc.main(["--smoke"]),
                 lambda: campaign_mc.measure_alpha(8),
                 lambda: fig5_weights.simulate_store(1e-4, 1, 64),
                 lambda: run_campaign(lambda g, n: g, 0),
                 lambda: tmr.tmr(lambda g: g)):
        try:
            call()
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError("ran without a GPU")
    fig5_weights.simulate_store(1e-4, 1, 64, device="cpu")   # asked for
    GenerationEngine(cfg, gen=1, device="cpu")        # asked for: fine
    ContinuousBatcher(cfg, device="cpu")
    PagedKVPool(cfg, spec, copies=False, device="cpu")
    print("ok")
""")


def _run(code: str) -> str:
    src = os.path.abspath(os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code.format(src=src,
                                           root=os.path.abspath(ROOT))],
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_port_imports_without_jax():
    out = _run(BLOCKED)
    assert "modules" in out
    # the walk reaches every module of the package, the later slices' too
    for m in ("repro_torch.launch.batching", "repro_torch.obs.registry",
              "repro_torch.obs.latency", "repro_torch.obs.trace",
              "repro_torch.kernels.hsiao_secded.ops",
              "repro_torch.kernels.inject_scrub.ops",
              "repro_torch.core.scheduler", "repro_torch.core.multpim",
              "repro_torch.kernels.netlist_exec.ops",
              "repro_torch.kernels.crossbar_nor.ops",
              "repro_torch.core.ecc", "repro_torch.core.seeds",
              "repro_torch.faults.campaign",
              "repro_torch.experiments.campaign_mc",
              "repro_torch.experiments.fig4_nn",
              "repro_torch.experiments.fig5_weights",
              "repro_torch.runtime.loop", "repro_torch.runtime.monitor",
              "repro_torch.optim.adamw", "repro_torch.optim.compression",
              "repro_torch.data.synthetic", "repro_torch.data.loader",
              "repro_torch.checkpoint.checkpointer",
              "repro_torch.launch.train"):
        assert m in out.split(), (m, out)


def test_entry_points_raise_without_gpu():
    assert "ok" in _run(NO_GPU)


def test_sources_name_no_jax_import():
    roots = [os.path.join(ROOT, "src", "repro_torch")]
    files = [os.path.join(d, f) for r in roots for d, _, fs in os.walk(r)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    for path in files:
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax",
                                         "import repro.", "from repro.",
                                         "from repro import",
                                         "import repro\n")), (path, s)
