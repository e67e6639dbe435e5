"""`repro_torch.launch.hlo_stats` against the reference's
`parse_collectives`: the collectives of `tests/test_launch.py`'s
SAMPLE_HLO as the port's recorder logs them, (op, result bytes, group
size), give the same `CollectiveStats` to the byte.  The sample's sixth
line, the ``-done`` half of an async all-reduce, is skipped by the
reference and has no record: the port issues no async pairs."""
from __future__ import annotations

import pytest

from repro.launch import hlo_stats as R
from repro_torch.launch import hlo_stats as P

SAMPLE_HLO = """
  %all-reduce.1 = f32[2,32768,8192]{2,1,0} all-reduce(%x), channel_id=17, replica_groups=[16,16]<=[256], to_apply=%add
  %ag = bf16[8,5120,16384]{2,0,1} all-gather(%w), dims={1}, replica_groups={{0,1,2,3},{4,5,6,7}}
  %rs = (f32[128]{0}, f32[128]{0}) reduce-scatter(%a, %b), replica_groups=[2,8]<=[16]
  %cp = bf16[1,4096]{1,0} collective-permute(%y), source_target_pairs={{0,1}}
  %a2a = f32[64,64]{1,0} all-to-all(%z), replica_groups=[4,4]<=[16]
  %ard = f32[9]{0} all-reduce-done(%start)
"""

#: SAMPLE_HLO's collectives: (op, result bytes, group); a permute has no
#: replica groups, which the reference counts as a group of 2
RECORDS = [
    ("all-reduce", 2 * 32768 * 8192 * 4, 16),
    ("all-gather", 8 * 5120 * 16384 * 2, 4),
    ("reduce-scatter", 2 * 128 * 4, 8),
    ("collective-permute", 1 * 4096 * 2, 2),
    ("all-to-all", 64 * 64 * 4, 4),
]


def _same(a, b):
    assert a.per_op_bytes == b.per_op_bytes
    assert a.per_op_count == b.per_op_count
    assert a.per_op_group == b.per_op_group
    assert a.total_result_bytes == b.total_result_bytes
    assert a.link_traffic_bytes() == b.link_traffic_bytes()


def test_records_give_the_reference_stats():
    _same(P.collective_stats(RECORDS), R.parse_collectives(SAMPLE_HLO))


@pytest.mark.parametrize("n", [2, 4, 16])
def test_ring_model_factors(n):
    """all-reduce 2(n-1)/n, all-gather (n-1)/n, as the reference's."""
    hlo = (f"%ar = f32[100]{{0}} all-reduce(%x), replica_groups=[1,{n}]<=[{n}]\n"
           f"%ag = f32[100]{{0}} all-gather(%x), replica_groups=[1,{n}]<=[{n}]")
    got = P.collective_stats([("all-reduce", 400, n), ("all-gather", 400, n)])
    _same(got, R.parse_collectives(hlo))
    assert got.link_traffic_bytes() == pytest.approx(
        400 * 2 * (n - 1) / n + 400 * (n - 1) / n)


def test_mean_group_and_barrier():
    """Groups average per kind; a barrier carries no bytes; an empty log
    is all zeros."""
    st = P.collective_stats([("all-gather", 8, 2), ("all-gather", 16, 4),
                             ("barrier", 0, 4)])
    assert st.per_op_group == {"all-gather": 3.0, "barrier": 4.0}
    assert st.per_op_count == {"all-gather": 2, "barrier": 1}
    assert st.link_traffic_bytes() == pytest.approx(24 * 2 / 3)
    empty = P.collective_stats([])
    assert (empty.per_op_bytes, empty.total_result_bytes,
            empty.link_traffic_bytes()) == ({}, 0, 0.0)


def test_dtype_bytes_are_the_reference_table():
    assert P.DTYPE_BYTES == R.DTYPE_BYTES
