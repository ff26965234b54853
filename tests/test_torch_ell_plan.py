"""The layout of the K1 row kernels (ops/ell.py:ell_plan), on the CPU.

The kernels (ops/cuda/ell_edge_conv.cu: ell_fwd_rows, ell_dp_rows,
ell_dq_rows) run only on the card; their (block, thread, chunk) -> (row,
channels) map is `EllPlan.chunk_of`, which these tests enumerate: every
output element is written by exactly one lane, for rows of every width
class, both dtypes, the 16-byte and the element body, split rows, and a
last block that is only partly filled, for the forward's plans and for
dp's and dq's. The card tests (tests/test_torch_cuda.py) check that the
library launches these plans and that its bits are the plain version's."""
import numpy as np
import pytest
import torch

from stinet_tpu_torch.ops.ell import (KIND_CHUNKS, KINDS, MAX_CHUNKS,
                                      THREADS, ell_plan)

WIDTHS = (1, 3, 4, 8, 20, 64, 128, 130, 256, 512, 520)
DTYPES = (torch.float32, torch.bfloat16)


def _writes(plan):
    """[V, H] count of the lanes that write each output element."""
    b, t, c = np.meshgrid(np.arange(plan.blocks), np.arange(THREADS),
                          np.arange(plan.chunks), indexing="ij")
    row, j = plan.chunk_of(b, t, c)
    live = (row < plan.v) & (j < plan.row_chunks)
    counts = np.zeros((plan.v, plan.h), np.int64)
    n = plan.chunk_channels
    for e in range(n):
        ch = j * n + e
        ok = live & (ch < plan.h)
        np.add.at(counts, (row[ok], ch[ok]), 1)
    return counts


def _splits(v, h, dtype, kind="sum"):
    """The default plan of `kind` and every other split of its rows the
    plan allows."""
    base = ell_plan(v, h, dtype, kind=kind)
    plans = [base]
    for groups in range(1, 4 * base.groups + 1):
        try:
            split = ell_plan(v, h, dtype, groups=groups, kind=kind)
        except ValueError:
            continue
        if split != base:
            plans.append(split)
    return plans


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("v", [37, 1001])
def test_ell_plan_writes_every_element_once(v, h, dtype):
    for plan in _splits(v, h, dtype):
        assert 32 % plan.lanes == 0, plan            # whole groups a warp
        assert 1 <= plan.chunks <= MAX_CHUNKS, plan
        # the last block is only partly filled
        assert (plan.v * plan.groups) % plan.groups_per_block != 0, plan
        assert plan.blocks == -(-plan.v * plan.groups
                                // plan.groups_per_block)
        counts = _writes(plan)
        assert counts.min() == 1 and counts.max() == 1, plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("v", [37, 1001])
@pytest.mark.parametrize("kind", ["dp", "dq"])
def test_ell_gradient_plans_write_every_element_once(kind, v, h, dtype):
    """dp's and dq's plans, the default split of each and every other
    split the plan allows (fewer groups too), cover every output element
    exactly once, with whole groups a warp and a partly filled last
    block."""
    plans = _splits(v, h, dtype, kind)
    assert plans[0].groups == -(-(-(-plans[0].row_chunks // plans[0].lanes))
                                // KIND_CHUNKS[kind])
    for plan in plans:
        assert 32 % plan.lanes == 0, plan
        assert 1 <= plan.chunks <= MAX_CHUNKS, plan
        assert (plan.v * plan.groups) % plan.groups_per_block != 0, plan
        counts = _writes(plan)
        assert counts.min() == 1 and counts.max() == 1, plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h", WIDTHS)
def test_ell_plan_lanes_chunks_and_body(h, dtype):
    """lanes = min(32, ceil(H*es/16)) up to a power of two, chunks =
    ceil(H*es / (16*lanes)) while that is at most MAX_CHUNKS, else that
    many split evenly over the fewest groups; 16-byte loads
    only on rows a multiple of 16 bytes that are aligned; an unaligned view
    takes the same layout with element loads; neighbouring lanes hold
    neighbouring chunks (coalesced loads)."""
    es = dtype.itemsize
    plan = ell_plan(1001, h, dtype)
    need = -(-h * es // 16)
    assert plan.lanes == 1 << (min(32, need) - 1).bit_length()
    assert plan.row_chunks == need
    per_lane = -(-need // plan.lanes)
    assert plan.groups == -(-per_lane // MAX_CHUNKS)
    assert plan.chunks == -(-per_lane // plan.groups)
    assert plan.vector == ((h * es) % 16 == 0)
    unaligned = ell_plan(1001, h, dtype, aligned=False)
    assert not unaligned.vector
    assert unaligned._replace(vector=plan.vector) == plan
    rows, chunks = plan.chunk_of(0, np.arange(plan.lanes), 0)
    assert (rows == 0).all()
    assert (chunks == np.arange(plan.lanes)).all()


def test_ell_plan_main_path_layouts():
    """The layouts the flagship model's calls take, as the design names
    them."""
    bf16, f32 = torch.bfloat16, torch.float32
    got = {(dt, h): ell_plan(6144, h, dt) for dt in (bf16, f32)
           for h in (128, 256, 512)}
    assert (got[bf16, 512].lanes, got[bf16, 512].chunks) == (32, 2)
    assert (got[bf16, 128].lanes, got[bf16, 128].chunks) == (16, 1)
    assert got[bf16, 128].groups_per_block == 16    # 2 rows a warp
    assert (got[f32, 128].lanes, got[f32, 128].chunks) == (32, 1)
    assert (got[f32, 256].lanes, got[f32, 256].chunks) == (32, 2)
    # f32 H=512: 4 chunks a lane split into two groups of 2
    assert (got[f32, 512].lanes, got[f32, 512].chunks,
            got[f32, 512].groups) == (32, 2, 2)
    assert all(p.vector and p.groups == 1 for k, p in got.items()
               if k != (f32, 512))
    split = ell_plan(6144, 512, bf16, groups=2)
    assert (split.chunks, split.groups, split.blocks) == (1, 2, 1536)


def test_ell_plan_is_cached_and_refuses_empty_groups():
    assert ell_plan(6144, 512, torch.bfloat16) is ell_plan(
        6144, 512, torch.bfloat16)
    with pytest.raises(ValueError):   # 2 chunks a lane cannot fill 3 groups
        ell_plan(6144, 512, torch.bfloat16, groups=3)
    with pytest.raises(ValueError):   # 4 chunks a lane in one group
        ell_plan(64, 512, torch.float32, groups=1)
    tail = ell_plan(0, 512, torch.float32)
    assert tail.blocks == 0


def test_ell_plan_gradient_layouts():
    """The default splits of dp and dq at the flagship's level-2 shape
    (V_pad 6144, H=512 bf16), as the sweep (sweep_k1.py) chose them: both
    in 2 groups of 32 lanes x 1 chunk a row (12288 warps, not the
    forward's 6144 of 32 lanes x 2 chunks); and the kinds' order, which is
    the library's."""
    bf16 = torch.bfloat16
    assert KINDS == ("sum", "dp", "dq")
    dp = ell_plan(6144, 512, bf16, kind="dp")
    dq = ell_plan(6144, 512, bf16, kind="dq")
    assert (dp.lanes, dp.chunks, dp.groups, dp.blocks) == (32, 1, 2, 1536)
    assert dq == dp
    assert dp.vector and dq.vector
    fwd = ell_plan(6144, 512, bf16)
    assert (fwd.chunks, fwd.groups) == (2, 1)
    assert ell_plan(6144, 512, bf16, groups=2) == dp
    f32_dq = ell_plan(6144, 512, torch.float32, kind="dq")
    assert (f32_dq.chunks, f32_dq.groups) == (1, 4)
    with pytest.raises(ValueError):
        ell_plan(6144, 512, bf16, kind="dx")
