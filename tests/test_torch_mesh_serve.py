"""The port's sharded scrub ops, batcher and ``serve --mesh`` on a 2x2
world of gloo ranks on the CPU (`launch.mesh.spawn`), against the JAX
package's single-device results, bit for bit:

* the sharded scrub ops (diagonal parity, Hsiao, inject+scrub) with 37
  blocks (not a multiple of 4), with and without flipped parity rows,
  against each single launch and the reference's `scrub` /
  `inject_scrub` (after tests/test_sharded_engine.py:168);
* the batcher's join-live on 2x2 for the reference's MESH_SCHEMES
  (tests/test_batching.py:243), equal to alone and to the reference's
  single-device batcher;
* the engine with the flash kernel on 2x2 (a model axis of 2), equal to
  the reference's single-device engine with its Pallas flash;
* ``serve --mesh 2x2`` through its own spawn, equal to the run without a
  mesh.

The engine on every mesh shape is in tests/test_torch_mesh.py.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax.numpy as jnp

import _mesh_worker as W
from _mesh_refs import (MESH_SCHEMES, P_BIT, SPEC, masks, ops_inputs,
                        reference_setup, runs)
from repro.faults import TransientBitFlips as JFlips
from repro.launch.engine import GenerationEngine as JEngine
from repro.launch.engine import fetch_telemetry as j_fetch
from repro.kernels.diag_parity import encode_parity as j_encode
from repro.kernels.diag_parity import scrub as j_scrub
from repro.kernels.hsiao_secded import encode_hsiao as j_encode_h
from repro.kernels.hsiao_secded import scrub as j_scrub_h
from repro.kernels.inject_scrub import inject_scrub as j_inject_scrub
from repro.launch.batching import BatchSpec as JSpec
from repro.launch.batching import ContinuousBatcher as JBatcher
from repro.launch.batching import Request as JRequest
from repro.reliability.scheme import parse_scheme as j_parse
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import spawn
from repro_torch.reliability import parse_scheme

#: the engine runs with the flash kernel on the 2x2 mesh, and their fault
#: rate: one at which ECC corrects and the tokens still follow the prompt
FLASH_RUNS = ["ecc", "ecc+tmr-parallel-votes"]
FLASH_P = 1e-4


@pytest.fixture(scope="module")
def setup():
    s = reference_setup()
    chosen = [r for r in runs() if r[0] in FLASH_RUNS]
    s["flash_runs"] = [
        (name, scheme, kw, masks(JFlips(FLASH_P), s["key"], s["jparams"],
                                 3 if "tmr" in name else 1))
        for name, scheme, kw, _ in chosen]
    s["flash_jruns"] = [(name, jscheme, kw)
                        for name, _, kw, jscheme in chosen]
    return s


@pytest.fixture(scope="module")
def launched(setup):
    """The 2x2 world, started in the background so that it and the
    reference's batcher runs overlap."""
    s = setup
    runs = [(n, s["masks"][3 if "tmr" in n else 1]) for n in MESH_SCHEMES]
    tasks = [("ops", W.sharded_ops, ops_inputs()),
             ("batcher", W.batcher_join,
              (s["cfg"], s["params_np"], s["prompts"], SPEC, runs)),
             ("flash", W.engine_grid,
              (s["cfg"].replace(attention_impl="pallas"), s["params_np"],
               s["tokens"], s["flash_runs"]))]
    pool = ThreadPoolExecutor(1)
    yield pool.submit(spawn, W.world, 4, args=((2, 2), tasks), device="cpu")
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def refs(setup, launched):
    """The reference's single-device batcher alone on every MESH_SCHEMES
    scheme (while the world runs)."""
    s = setup
    out = {}
    for name in MESH_SCHEMES:
        jb = JBatcher(s["cfg_j"], j_parse(name), JSpec(**SPEC))
        jb.prepare(s["jparams"], key=s["key"], fault=JFlips(P_BIT))
        out[name] = jb.run([JRequest(9, s["prompts"][8], 5)])[0]
    return out


@pytest.fixture(scope="module")
def flash_refs(setup, launched):
    """The reference's single-device engine with its Pallas flash on
    FLASH_RUNS (while the world runs)."""
    s = setup
    cfg = s["cfg_j"].replace(attention_impl="pallas")
    out = {}
    for name, jscheme, kw in s["flash_jruns"]:
        eng = JEngine(cfg, jscheme, **kw)
        store, prep = eng.prepare(s["jparams"], key=s["key"],
                                  fault=JFlips(FLASH_P))
        toks, tel = eng.generate(store, {"tokens": jnp.asarray(s["tokens"])})
        out[name] = (np.asarray(toks), j_fetch({**prep, **tel}))
    return out


@pytest.fixture(scope="module")
def ranks(launched, refs, flash_refs):
    return launched.result()


def test_sharded_scrub_ops_match(ranks):
    words, mask = ops_inputs()
    corrupted = jnp.asarray(words ^ mask)
    parity, hparity = j_encode(jnp.asarray(words)), \
        j_encode_h(jnp.asarray(words))
    flipped = [jnp.asarray(W.flip_parity(np.array(p)))
               for p in (parity, hparity)]
    want = {"diag": j_scrub(corrupted, parity),
            "hsiao": j_scrub_h(corrupted, hparity),
            "diag-parity": j_scrub(corrupted, flipped[0]),
            "hsiao-parity": j_scrub_h(corrupted, flipped[1]),
            "inject": j_inject_scrub(jnp.asarray(words), parity,
                                     jnp.asarray(mask))}
    for name, ref in want.items():
        ref = [np.asarray(x).view(np.int32) if x.dtype == jnp.uint32
               else np.asarray(x) for x in ref]
        assert int(ref[-1][0]) > 0                 # live counters
        if name.endswith("-parity"):
            assert int(ref[-1][1]) > 0             # parity rows fixed
        for r in ranks:
            one, many = r["ops"][name]
            for a, b, c in zip(one, many, ref):
                np.testing.assert_array_equal(a, b, err_msg=name)
                np.testing.assert_array_equal(a, c, err_msg=name)


@pytest.mark.parametrize("name", MESH_SCHEMES)
def test_join_matches_alone_on_mesh(refs, ranks, name):
    """A request joining a live batch on the 2x2 mesh equals it served
    alone there, and the reference's single-device batcher alone."""
    single = refs[name]
    for r in ranks:
        got = r["batcher"][name]
        np.testing.assert_array_equal(got["joined"][0], got["alone"][0])
        assert got["joined"][1] == got["alone"][1]
        np.testing.assert_array_equal(got["alone"][0],
                                      np.asarray(single.tokens))
        assert got["alone"][1] == single.vote_disagreements


def test_serve_mesh_2x2(capfd):
    """``serve --mesh 2x2`` (its own spawn) gives the run without a mesh:
    tokens and counters, rank 0 alone printing."""
    ranks = serve.main(["--smoke", "--device", "cpu", "--arch",
                        "phi3-mini-3.8b", "--batch", "2", "--prompt-len",
                        "8", "--gen", "4", "--scheme", "ecc+tmr-serial",
                        "--inject-p-bit", "1e-5", "--mesh", "2x2"])
    out = capfd.readouterr().out
    assert out.count("mesh=data=2xmodel=2") == 1
    assert "backend gloo" in out
    cfg = get_config("phi3-mini-3.8b").smoke()
    inputs = serve.make_inputs(cfg, 2, 8, 0, "cpu")
    one = serve.serve(cfg, inputs["params"], inputs["tokens"],
                      parse_scheme("ecc+tmr-serial"), gen=4, p_bit=1e-5,
                      device="cpu")
    assert len(ranks) == 4
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["tokens"]),
                                      one["tokens"].numpy())
        for k, v in one["stats"].items():
            np.testing.assert_array_equal(np.asarray(r["stats"][k]),
                                          np.asarray(v), err_msg=k)
    assert int(one["stats"]["ecc_corrected"]) > 0



@pytest.mark.parametrize("name", FLASH_RUNS)
def test_flash_on_a_model_axis_matches_reference(flash_refs, ranks, name):
    """The flash kernel (``attention_impl='pallas'``; its plain version on
    the CPU) on the 2x2 mesh, whose model axis is 2: every rank gathers
    whole leaves and computes whole heads, so flash runs unchanged and
    gives the reference's single-device engine with its Pallas flash:
    tokens and every counter bit for bit, with live counters."""
    ref_toks, ref_tel = flash_refs[name]
    assert int(ref_tel["ecc_corrected"]) > 0
    for r in ranks:
        got = r["flash"][name]
        assert got["exec_shape"]["model"] == 2
        np.testing.assert_array_equal(got["tokens"], ref_toks)
        assert set(got["stats"]) == set(ref_tel)
        for k in ref_tel:
            np.testing.assert_array_equal(got["stats"][k], ref_tel[k],
                                          err_msg=k)
