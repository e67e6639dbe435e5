"""The port's entry points (`launch.serve`, `launch.train`) on the ssm,
hybrid, vlm and encdec families' smoke configs, on the CPU:

* `serve` one-shot under ``ecc+tmr-parallel --vote-every 2 --vote-cache``
  at p_bit 1e-6 agrees with the clean run, with the stub modality inputs
  (vis_emb, enc_emb) drawn by `make_inputs` from the run's generator;
* `serve --server` refuses these families with the batcher's message;
* `train` runs two protected steps of each, its default arch is the
  reference's, mamba2-130m, and its batches carry the modality input,
  the same for the same step and new for each step.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve, train

ARCHS = ["mamba2-130m", "recurrentgemma-2b", "llama-3.2-vision-11b",
         "seamless-m4t-medium"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_family(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--smoke", "--batch", "2",
                "--prompt-len", "36", "--gen", "4", "--scheme",
                "ecc+tmr-parallel", "--vote-every", "2", "--vote-cache",
                "--inject-p-bit", "1e-6"])
    out = capsys.readouterr().out
    assert f"[serve] {arch} scheme=ecc+tmr-parallel" in out
    assert "agreement with clean run: 1.000" in out
    assert "uncorrectable=0" in out


def test_make_inputs_draws_the_modality_inputs():
    for arch, key, shape in (
            ("llama-3.2-vision-11b", "vis_emb", (2, 16, 128)),
            ("seamless-m4t-medium", "enc_emb", (2, 12, 128)),
            ("mamba2-130m", None, None)):
        cfg = get_config(arch).smoke()
        a = serve.make_inputs(cfg, 2, 12, seed=3, device="cpu")
        b = serve.make_inputs(cfg, 2, 12, seed=3, device="cpu")
        assert sorted(a["modality"]) == ([key] if key else [])
        if key:
            x = a["modality"][key]
            assert tuple(x.shape) == shape and x.dtype == torch.float32
            assert torch.equal(x, b["modality"][key])
            assert 0.8 < float(x.std()) < 1.2


@pytest.mark.parametrize("arch", ARCHS)
def test_server_refuses_unpaged_families(arch):
    with pytest.raises(ValueError, match="caches are not paged yet"):
        serve.main(["--device", "cpu", "--arch", arch, "--smoke",
                    "--server", "--prompt-len", "16", "--gen", "4",
                    "--requests", "2", "--slots", "2"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_each_family(arch, capsys):
    out = train.main(["--device", "cpu", "--arch", arch, "--smoke",
                      "--steps", "2", "--batch", "2", "--seq", "32",
                      "--ecc-scrub-every", "1", "--inject-p-bit", "1e-7"])
    assert out["final_step"] == 2 and out["monitor"]["scrubs"] == 2
    assert f"[train] {arch}" in capsys.readouterr().out


def test_train_default_arch_is_the_references():
    assert train.parser().parse_args([]).arch == "mamba2-130m"


@pytest.mark.parametrize("arch,key,shape", [
    ("llama-3.2-vision-11b", "vis_emb", (2, 16, 128)),
    ("seamless-m4t-medium", "enc_emb", (2, 32, 128))])
def test_train_batches_carry_the_modality_input(arch, key, shape):
    args = train.parser().parse_args(["--device", "cpu", "--arch", arch,
                                      "--smoke", "--steps", "2", "--batch",
                                      "2", "--seq", "32"])
    _, loop, _ = train.build(args)
    b0, b0_again, b1 = (loop.batch_at(s) for s in (0, 0, 1))
    assert sorted(b0) == sorted(["tokens", key])
    assert tuple(b0[key].shape) == shape
    assert torch.equal(b0[key], b0_again[key])
    assert not torch.equal(b0[key], b1[key])
