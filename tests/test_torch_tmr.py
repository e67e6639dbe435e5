"""`core/tmr.py` in the port: the disciplines' cost table against the JAX
package's (one definition, read by `reliability.scheme`), and the `tmr`
wrapper: three runs on generators derived from one seed, voted per bit
through the registry's `tmr_vote` (exact)."""
import pytest
import torch

from repro_torch.core import tmr as TT
from repro_torch.faults import derive_seed
from repro_torch.reliability import backend
from repro_torch.reliability import scheme as TS

try:    # without JAX (as on a GPU machine) only the JAX-free cases run
    from repro.core import tmr as JT
    from repro.reliability import scheme as JS
except ImportError:
    JT = None

needs_jax = pytest.mark.skipif(JT is None, reason="needs the JAX package")


@needs_jax
@pytest.mark.parametrize("mode", ["serial", "parallel", "semi_parallel"])
def test_costs_match_jax(mode):
    t, j = TT.TMR_COSTS[mode], JT.TMR_COSTS[mode]
    assert (t.latency_x, t.area_x, t.throughput_x) == \
        (j.latency_x, j.area_x, j.throughput_x)
    to, jo = TS.Tmr(mode).overhead(), JS.Tmr(mode).overhead()
    assert (to.storage_x, to.latency_x, to.area_x, to.throughput_x) == \
        (jo.storage_x, jo.latency_x, jo.area_x, jo.throughput_x)
    assert TS.Tmr(mode).overhead().describe() == \
        JS.Tmr(mode).overhead().describe()


def test_one_cost_table():
    assert TS.TMR_COSTS is TT.TMR_COSTS
    assert sorted(TT.TMR_COSTS) == ["parallel", "semi_parallel", "serial"]
    assert TT.TMR_COSTS["semi_parallel"].throughput_x == pytest.approx(1 / 3)


def _noisy(g, x):
    flip = torch.rand(x.shape, generator=g, device=g.device) < 0.2
    return torch.where(flip, -x, x)


@pytest.mark.parametrize("mode", ["serial", "parallel", "semi_parallel"])
def test_tmr_votes_three_derived_runs(mode):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    wrapped = TT.tmr(_noisy, mode=mode, device="cpu")
    assert wrapped.cost == TT.TMR_COSTS[mode]
    out = wrapped(12, x)
    runs = [_noisy(torch.Generator().manual_seed(derive_seed(12, i)), x)
            for i in range(3)]
    assert torch.equal(out.view(torch.int32),
                       TT.vote_array(*runs).view(torch.int32))
    # voting beats one noisy copy (the reference's property)
    single = float((runs[0] != x).float().mean())
    errs = float((out != x).float().mean())
    assert errs <= single + 0.05 and errs < single
    assert torch.equal(wrapped(12, x), out)          # replays


def test_tmr_votes_trees_of_any_dtype():
    def fn(g, n):
        bits = torch.rand(n, generator=g) < 0.1
        return {"b": bits, "w": bits.to(torch.int32) * 7,
                "h": bits.to(torch.bfloat16)}

    out = TT.tmr(fn, device="cpu")(3, 1000)
    runs = [fn(torch.Generator().manual_seed(derive_seed(3, i)), 1000)
            for i in range(3)]
    for k in out:
        want = TT.vote_array(*(r[k] for r in runs))
        assert out[k].dtype == want.dtype and torch.equal(out[k], want)


def test_tmr_default_voter_is_the_registry_op():
    calls = []
    vote = backend.dispatch("tmr_vote")

    def spy(a, b, c):
        calls.append(a.shape)
        return vote(a, b, c)

    x = torch.ones(10)
    a = TT.tmr(lambda g, v: v * 2, device="cpu")(0, x)
    b = TT.tmr(lambda g, v: v * 2, voter=spy, device="cpu")(0, x)
    assert torch.equal(a, b) and calls == [(10,)]
    with pytest.raises(ValueError):
        TT.tmr(_noisy, mode="quad", device="cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16, torch.float16, torch.int32,
                                   torch.int64])
def test_vote_takes_every_dtype_the_kernel_takes(dtype):
    """The plain voter and the op on a CPU tensor vote any dtype on its raw
    bits, as the kernel votes a CUDA tensor bytewise: one flipped bit in
    any one copy (NaN-producing ones included) is voted out exactly."""
    from repro_torch.kernels.tmr_vote import vote
    from repro_torch.kernels.tmr_vote.ref import vote_ref

    g = torch.Generator().manual_seed(1)
    n = 999
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    bits = ints[torch.empty((), dtype=dtype).element_size()]
    width = torch.iinfo(bits).bits
    raw = torch.randint(-2**31, 2**31, (n,), dtype=torch.int64, generator=g)
    x = raw.to(bits).view(dtype)
    who = torch.randint(0, 3, (n,), generator=g)    # the one copy hit
    copies = []
    for i in range(3):
        hit = who == i
        bit = torch.randint(0, width, (n,), generator=g)
        flip = torch.where(hit, torch.ones(n, dtype=torch.int64) << bit, 0)
        copies.append((x.view(bits) ^ flip.to(bits)).view(dtype))
    for voted in (vote_ref(*copies), vote(*copies)):
        assert voted.dtype == dtype
        assert torch.equal(voted.view(bits), x.view(bits))
