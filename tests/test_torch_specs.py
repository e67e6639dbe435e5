"""The port's train policies, rules overrides and dry-run shape registry
(`repro_torch.configs`, `repro_torch.launch.specs`) equal the JAX
package's for every arch, and the scenarios of tests/test_launch.py:36-57
hold for the port.  Also `specs.microbatches`, the reference's
`lower_cell` clamp, on the meshes a training cell uses."""
import pytest

from repro.configs import get_rules_overrides as j_overrides
from repro.configs import get_train_policy as j_policy
from repro.configs import list_archs as j_archs
from repro.launch import specs as JS
from repro_torch.configs import (DEFAULT_TRAIN_POLICY, get_config,
                                 get_rules_overrides, get_train_policy,
                                 list_archs)
from repro_torch.launch import specs as PS
from repro_torch.pshard import AbstractMesh

ARCHS = list_archs()


def test_same_archs():
    assert ARCHS == j_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_policy_and_overrides_equal_reference(arch):
    assert get_train_policy(arch) == j_policy(arch)
    for serve in (False, True):
        assert get_rules_overrides(arch, serve=serve) == \
            j_overrides(arch, serve=serve)
        assert PS.arch_rules(arch, serve=serve).table == \
            JS.arch_rules(arch, serve=serve).table
    extra = {"kv_seq": (), "batch": ("data",)}
    assert PS.arch_rules(arch, extra).table == JS.arch_rules(arch,
                                                             extra).table


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_registry_equals_reference(arch):
    assert {k: (v.name, v.kind, v.seq, v.batch)
            for k, v in PS.SHAPES.items()} == \
        {k: (v.name, v.kind, v.seq, v.batch) for k, v in JS.SHAPES.items()}
    assert PS.ENCDEC_MEM_LEN == JS.ENCDEC_MEM_LEN
    from repro.configs import get_config as j_config
    for name in PS.SHAPES:
        assert PS.skip_reason(get_config(arch), PS.SHAPES[name]) == \
            JS.skip_reason(j_config(arch), JS.SHAPES[name])
        assert PS.applicable(get_config(arch), PS.SHAPES[name]) == \
            JS.applicable(j_config(arch), JS.SHAPES[name])


def test_shape_applicability():
    assert PS.skip_reason(get_config("deepseek-67b"), PS.SHAPES["long_500k"])
    assert PS.applicable(get_config("mamba2-130m"), PS.SHAPES["long_500k"])
    assert PS.applicable(get_config("recurrentgemma-2b"),
                         PS.SHAPES["long_500k"])
    for arch in ARCHS:
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert PS.applicable(get_config(arch), PS.SHAPES[s])


def test_train_policies_resolve():
    for arch in ARCHS:
        p = get_train_policy(arch)
        assert set(p) >= {"microbatches", "param_dtype", "opt_dtype",
                          "grad_dtype"}
    assert get_train_policy("llama4-maverick-400b-a17b")["param_dtype"] == \
        "bfloat16"
    assert get_train_policy("phi3-mini-3.8b") == DEFAULT_TRAIN_POLICY


def test_serve_rules_override_only_in_serve_mode():
    base = PS.arch_rules("llama4-maverick-400b-a17b", serve=False)
    serve = PS.arch_rules("llama4-maverick-400b-a17b", serve=True)
    assert base.axes_for("expert") == ("model",)
    assert serve.axes_for("expert") == ("data",)
    assert serve.axes_for("model_dim") == ()
    assert PS.arch_rules("mamba2-130m").axes_for("model_dim") == ()


@pytest.mark.parametrize("shape,batch,want", [
    ((1, 1), 8, 8), ((2, 2), 8, 4), ((4, 1), 8, 2), ((8, 1), 8, 1),
    ((16, 16), 256, 16), ((2, 1), 64, 16), ((4, 1), 64, 16)])
def test_microbatches_clamp_as_lower_cell(shape, batch, want):
    """min(K, max(1, batch // dp)), dp the product of the pod and data
    axes (src/repro/launch/dryrun.py:48-53)."""
    mesh = AbstractMesh(shape, ("data", "model"))
    assert PS.microbatches(16, batch, mesh) == want
    assert PS.microbatches(16, batch, AbstractMesh(
        (2,) + shape, ("pod", "data", "model"))) == min(
        16, max(1, batch // (2 * shape[0])))
    assert PS.microbatches(4, batch, None) == min(4, batch)
