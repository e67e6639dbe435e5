"""The port's packed arena (repro_torch.core.arena) against the JAX
reference (repro.core.arena): the same tree gives the same words and the
same spec; unpacked leaves are views of the arena (it is the storage)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import arena as jarena
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.core import arena
from repro_torch.core import tree as T
from repro_torch.models.params import from_numpy


def _np_tree(seed=0):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(37, 5).astype(np.float32),
            "blk": {"odd": rs.randn(3, 7).astype(ml_dtypes.bfloat16),
                    "even": rs.randn(4, 8).astype(ml_dtypes.bfloat16),
                    "b": rs.randn(64).astype(np.float32)},
            "i": rs.randint(-1000, 1000, size=(10,)).astype(np.int32),
            "s": np.float32(rs.randn())}


def _jax_words(tree_np):
    words, spec = jarena.pack(jax.tree.map(jnp.asarray, tree_np))
    return np.asarray(words).view(np.int32), spec


def _bits(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.view(torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def test_same_tree_same_words_and_spec():
    tree_np = _np_tree()
    want, jspec = _jax_words(tree_np)
    params = from_numpy(tree_np)
    words, spec = arena.words_of(params)
    np.testing.assert_array_equal(words.numpy(), want)
    assert spec.n_words == jspec.n_words
    for l, jl in zip(spec.leaves, jspec.leaves):
        assert (l.offset, l.n_words, l.pad_words, l.shape) == \
            (jl.offset, jl.n_words, jl.pad_words, jl.shape)
    assert [".".join(p) for p in spec.paths] == \
        [jax.tree_util.keystr(p, simple=True, separator=".")
         for p, _ in jax.tree_util.tree_flatten_with_path(tree_np)[0]]


def test_phi3_smoke_params_pack_identically():
    cfg = get_config("phi3-mini-3.8b").smoke().replace(n_layers=2)
    jparams = JP.materialize(jax.random.PRNGKey(3), JT.model_specs(cfg))
    want, jspec = _jax_words(jax.tree.map(np.asarray, jparams))
    params = from_numpy(jax.tree.map(np.asarray, jparams))
    words, spec = arena.words_of(params)
    np.testing.assert_array_equal(words.numpy(), want)
    assert [".".join(p) for p in spec.paths] == [
        "embed.head", "embed.tok", "final_ln", "layers.attn.ln",
        "layers.attn.wkv", "layers.attn.wo", "layers.attn.wq",
        "layers.mlp.ln", "layers.mlp.w_down", "layers.mlp.w_up"]


def test_unpack_views_round_trip_and_share_storage():
    tree_np = _np_tree(1)
    words, spec = arena.pack(from_numpy(tree_np))
    params = arena.unpack(words, spec)
    for x, a in zip(T.leaves(params), jax.tree.leaves(tree_np)):
        np.testing.assert_array_equal(_bits(x), _jbits(a))
    # the arena is the storage: a write to the words shows in the leaf
    w_spec = spec.leaves[T.paths(params).index(("w",))]
    words[w_spec.offset] ^= 1 << 31
    assert params["w"].reshape(-1)[0].item() == -tree_np["w"].reshape(-1)[0]
    found, found_spec = arena.words_of(params)
    assert found.data_ptr() == words.data_ptr() and found_spec == spec


def test_words_of_packs_a_copy_for_loose_trees():
    loose = {"a": torch.arange(6, dtype=torch.float32), "b": torch.ones(3)}
    words, spec = arena.words_of(loose)
    assert words.numel() == spec.n_words == 64
    assert words.data_ptr() != loose["a"].data_ptr()


@pytest.mark.parametrize("n", [1, 5, 21, 63])
def test_bf16_odd_length_packs_like_reference(n):
    rs = np.random.RandomState(n)
    a = rs.randn(n).astype(ml_dtypes.bfloat16)
    want = np.asarray(jarena.leaf_to_words(jnp.asarray(a))).view(np.int32)
    got = arena.leaf_to_words(from_numpy({"x": a})["x"])
    np.testing.assert_array_equal(got.numpy(), want)
    if n % 2:
        assert (got[-1].item() >> 16) & 0xFFFF == 0   # zero pad half


def test_stacked_copies_unpack_to_strided_views():
    tree_np = _np_tree(2)
    words, spec = arena.pack(from_numpy(tree_np))
    words3 = torch.stack([words, words ^ 7, words])
    stacked = arena.unpack(words3, spec)
    for x, a in zip(T.leaves(stacked), jax.tree.leaves(tree_np)):
        assert tuple(x.shape) == (3,) + np.shape(a)
        np.testing.assert_array_equal(_bits(x[0]), _jbits(a))
    found, found_spec = arena.words_of(stacked, copies=3)
    assert found.data_ptr() == words3.data_ptr()
    assert torch.equal(found, words3) and found_spec == spec
