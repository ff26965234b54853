"""Segment reductions with a static `num_segments`.

PyTorch counterpart of `stinet_tpu/ops/segment.py` (the reference's
torch_scatter calls). Pad entries carry a segment id in the pad region (the
trash vertex), so no masking is needed here. Empty segments give 0, as
torch_scatter does. Forward only in this slice: `segment_max`'s
single-argmax gradient comes with the training slice.
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
    """Max of `data` rows per segment; empty segments give 0."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    idx = segment_ids.to(torch.int64).reshape(
        (-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    # include_self=False: a segment with no entries keeps its 0
    return out.scatter_reduce_(0, idx, data, "amax", include_self=False)
