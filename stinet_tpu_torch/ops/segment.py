"""Segment reductions with a static `num_segments`.

PyTorch counterpart of `stinet_tpu/ops/segment.py` (the reference's
torch_scatter calls). Pad entries carry a segment id in the pad region (the
trash vertex), so no masking is needed here. Empty segments give 0, as
torch_scatter does. `segment_max` routes its whole gradient to one
achieving row per (segment, feature), as torch_scatter's scatter_max does.
"""
import torch


def segment_sum(data, segment_ids, num_segments):
    """Sum of `data` rows per segment. data: [N, ...], ids: [N] int."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)


def segment_count(segment_ids, num_segments, dtype=torch.float32):
    """Number of entries per segment, [num_segments]."""
    ones = torch.ones(segment_ids.shape[0], dtype=dtype,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments, counts=None):
    """Mean of `data` rows per segment; empty segments give 0."""
    s = segment_sum(data, segment_ids, num_segments)
    if counts is None:
        counts = segment_count(segment_ids, num_segments, dtype=s.dtype)
    denom = torch.clamp(counts.to(s.dtype), min=1.0)
    return s / denom.reshape((-1,) + (1,) * (s.dim() - 1))


def segment_max(data, segment_ids, num_segments):
    """Max of `data` rows per segment; empty segments give 0. The gradient
    of each (segment, feature) goes whole to ONE achieving row, the one with
    the highest row index (stinet_tpu/ops/segment.py:102-121), not split
    among ties."""
    return _SegmentMax.apply(data, segment_ids, num_segments)


def _row_index(data):
    n = data.shape[0]
    idx = torch.arange(n, device=data.device)
    return idx.reshape((n,) + (1,) * (data.dim() - 1)).expand_as(data)


class _SegmentMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        idx = segment_ids.to(torch.int64).reshape(
            (-1,) + (1,) * (data.dim() - 1)).expand_as(data)
        out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                          dtype=data.dtype, device=data.device)
        # include_self=False: a segment with no entries keeps its 0
        out.scatter_reduce_(0, idx, data, "amax", include_self=False)
        if ctx.needs_input_grad[0]:
            # the argmax: highest row index among the rows that achieve
            # their segment's max (only non-empty segments have any)
            rows = _row_index(data)
            cand = torch.where(data == out.gather(0, idx), rows,
                               torch.full_like(rows, -1))
            arg = torch.full(out.shape, -1, dtype=torch.int64,
                             device=data.device)
            arg.scatter_reduce_(0, idx, cand, "amax", include_self=True)
            ctx.save_for_backward(idx, arg)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, arg = ctx.saved_tensors
        routed = _row_index(idx) == arg.gather(0, idx)
        d = g.gather(0, idx) * routed.to(g.dtype)
        return d, None, None
