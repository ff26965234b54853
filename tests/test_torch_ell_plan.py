"""The layout of the K1 forward kernel (ops/ell.py:ell_plan), on the CPU.

The kernel (ops/cuda/ell_edge_conv.cu: ell_fwd_rows) runs only on the card;
its (block, thread, chunk) -> (row, channels) map is `EllPlan.chunk_of`,
which these tests enumerate: every output element is written by exactly
one lane, for rows of every width class, both dtypes, the 16-byte and the
element body, split rows, and a last block that is only partly filled. The
card tests (tests/test_torch_cuda.py) check that the library launches this
plan and that its bits are the plain version's."""
import numpy as np
import pytest
import torch

from stinet_tpu_torch.ops.ell import MAX_CHUNKS, THREADS, ell_plan

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


def _splits(v, h, dtype):
    """The default plan and every split of its rows the plan allows."""
    base = ell_plan(v, h, dtype)
    plans = [base]
    for groups in range(base.groups + 1, 4 * base.groups + 1):
        try:
            plans.append(ell_plan(v, h, dtype, groups=groups))
        except ValueError:
            pass
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
