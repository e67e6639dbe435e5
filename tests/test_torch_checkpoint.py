"""The port's Checkpointer (`repro_torch.checkpoint`): every scenario of
`tests/test_checkpoint.py`, the elastic `restore_resharded` with `None`
shardings among them (its placement onto other mesh shapes is in
tests/test_torch_train_mesh.py), plus the port's own: tensors (float32,
bfloat16, int32, 0-d) round trip bit for bit through `restore_tensors`, a
snapshot is taken at `save` (later in-place writes do not reach it), and
strings and Python scalars round trip as numpy."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer, restore_resharded


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(16, 8, generator=g)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    state = _state()
    ck.save(7, state)
    out = ck.restore()
    np.testing.assert_array_equal(out["params"]["w"],
                                  state["params"]["w"].numpy())
    assert ck.latest_step() == 7


def test_gc_keeps_window(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _state())
    assert ck.all_steps() == [3, 4]


def test_async_save_is_consistent(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3, async_save=True)
    state = _state()
    want = state["params"]["w"].clone()
    ck.save(1, state)
    state["params"]["w"].add_(1.0)     # written in place after the save
    ck.wait()
    np.testing.assert_array_equal(ck.restore(1)["params"]["w"], want.numpy())


def test_atomicity_no_tmp_dirs_after_save(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(5, _state())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_crash_between_resave_renames_leaves_restorable_snapshot(tmp_path):
    """A re-save of an existing step moves it to step_X.old before
    publishing; if the process dies between the two renames, the aside
    copy must still be discoverable and restorable."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(5, {"x": np.arange(3)})
    final = os.path.join(str(tmp_path), "step_00000005")
    os.replace(final, final + ".old")        # simulate mid-_write crash
    ck2 = Checkpointer(str(tmp_path), async_save=False)
    assert ck2.latest_step() == 5
    assert np.array_equal(ck2.restore()["x"], np.arange(3))
    # a later save of the same step publishes normally and heals the aside
    ck2.save(5, {"x": np.arange(4)}, block=True)
    assert sorted(os.listdir(tmp_path)) == ["step_00000005"]
    assert np.array_equal(ck2.restore()["x"], np.arange(4))


def test_restore_missing_step_raises_filenotfound(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=1, async_save=False)
    ck.save(1, {"x": np.arange(2)})
    ck.save(2, {"x": np.arange(2)})          # keep=1 garbage-collects step 1
    with pytest.raises(FileNotFoundError):
        ck.restore(step=1)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()


def test_tensors_round_trip_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(3)
    state = {"a": {"f32": torch.randn(5, 7, generator=g),
                   "bf16": torch.randn(33, generator=g).to(torch.bfloat16)},
             "count": torch.tensor(12, dtype=torch.int32),
             "step": 9, "scheme": "ecc+tmr-parallel"}
    # a float with every bit pattern class: nan, inf, denormal, -0
    state["a"]["f32"][0, :4] = torch.tensor([float("nan"), float("inf"),
                                             1e-45, -0.0])
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(9, state)
    out = ck.restore_tensors()
    for key in ("f32", "bf16"):
        got, want = out["a"][key], state["a"][key]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16 if key == "bf16"
                                    else torch.int32),
                           want.view(torch.int16 if key == "bf16"
                                     else torch.int32))
    assert out["count"].dtype == torch.int32 and int(out["count"]) == 12
    assert out["count"].shape == ()
    assert int(out["step"]) == 9
    assert str(out["scheme"]) == "ecc+tmr-parallel"
    host = ck.restore()
    assert host["a"]["bf16"].dtype == np.uint16   # numpy has no bfloat16


def test_manifest_describes_the_tree(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(3, {"state": {"params": {"w": torch.zeros(2)}}, "step": 3})
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["paths"] == [["state", "params", "w"], ["step"]]
    assert not (tmp_path / "step_00000003" / "treedef.pkl").exists()


def test_restore_resharded_places_leaves(tmp_path):
    """Elastic restore: host arrays placed with explicit (new) shardings;
    None keeps a leaf whole (here with no mesh at all)."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    state = _state()
    ck.save(2, state)
    shardings = {"params": {"w": None}, "step": None}
    out = restore_resharded(ck, shardings)
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  state["params"]["w"].numpy())
    assert isinstance(out["params"]["w"], torch.Tensor)
    assert out["step"].shape == () and int(out["step"]) == 7
    # one None for the whole tree, as the reference maps every leaf
    whole = restore_resharded(ck, None, step=2)
    assert torch.equal(whole["params"]["w"], out["params"]["w"])
