"""ELL (padded neighbour table) message passing and children-table pooling.

PyTorch counterpart of `stinet_tpu/ops/ell.py`. Graph builders emit, beside
the COO edge list, a neighbour table

  nbr [V_pad, D] — for receiver v, slot d: sender id (pad slots -> trash)

and the EdgeConv message sum runs over the slot axis as row gathers with no
scatter. On a CUDA tensor `ell_edge_conv_sum` launches the hand-written
kernel `ops/cuda/ell_edge_conv.cu`; on a CPU tensor, or with impl="plain",
it runs `ell_edge_conv_sum_plain`, the same slot-ordered f32 sum in torch.
Forward only: the backward (dp step-sum, dq through `rev_dst`) comes with
the training slice.

Children-table pooling: the trace map (fine -> coarse) induces a children
table (coarse -> its fine vertices). Pooling is a gather + reduce over child
slots and unpooling a trace gather.
"""
import torch

from stinet_tpu_torch.ops import _cuda


def ell_edge_conv_sum(p, q, nbr, deg, impl=None):
    """out[v] = sum_{d < deg[v]} relu(p[v] + q[nbr[v, d]]).

    p, q: [V, H] f32; nbr: [V, D] int32 (every slot a valid row of q, pad
    slots at the trash row); deg: [V] f32 count of ELL-resident edges.
    Callers divide by the TOTAL degree (after adding any COO spill) for
    mean aggregation."""
    if _cuda.use_kernel(p, impl):
        return ell_edge_conv_sum_kernel(p, q, nbr, deg)
    return ell_edge_conv_sum_plain(p, q, nbr, deg)


def ell_edge_conv_sum_plain(p, q, nbr, deg):
    """Plain torch version: slots accumulated in f32 in order d=0..D-1, as
    stinet_tpu/ops/ell.py:_forward does, so the two agree bit for bit."""
    acc_dt = torch.promote_types(p.dtype, torch.float32)
    deg_i = deg.to(torch.int32)
    acc = torch.zeros(p.shape, dtype=acc_dt, device=p.device)
    zero = torch.zeros((), dtype=acc_dt, device=p.device)
    for d in range(nbr.shape[1]):
        m = torch.relu(p + q.index_select(0, nbr[:, d]))
        acc = acc + torch.where((d < deg_i)[:, None], m.to(acc_dt), zero)
    return acc.to(p.dtype)


def ell_edge_conv_sum_kernel(p, q, nbr, deg):
    """Launch `ell_edge_conv_sum_fwd_f32` (ops/cuda/ell_edge_conv.cu) on
    the current stream. Raises on a tensor it does not take or a failed
    launch; it never falls back to the plain version."""
    dev = p.device
    _cuda.check_tensor("p", p, torch.float32, 2, dev)
    _cuda.check_tensor("q", q, torch.float32, 2, dev)
    _cuda.check_tensor("nbr", nbr, torch.int32, 2, dev)
    _cuda.check_tensor("deg", deg, torch.float32, 1, dev)
    v, h = p.shape
    if q.shape[1] != h or nbr.shape[0] != v or deg.shape[0] != v:
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, q "
                         f"{tuple(q.shape)}, nbr {tuple(nbr.shape)}, deg "
                         f"{tuple(deg.shape)}")
    out = torch.empty_like(p)
    lib = _cuda.library("ell_edge_conv")
    rc = lib.ell_edge_conv_sum_fwd_f32(
        p.data_ptr(), q.data_ptr(), nbr.data_ptr(), deg.data_ptr(),
        out.data_ptr(), v, h, nbr.shape[1], dev.index, _cuda.stream_of(dev))
    _cuda.check_status(lib, "ell_edge_conv_sum_fwd_f32", rc)
    ell_edge_conv_sum_kernel.launches += 1
    return out


ell_edge_conv_sum_kernel.launches = 0


def _pool_sum(x, children, counts):
    """Child-slot sum in >= f32, slots in order."""
    cnt = counts.to(torch.int32)
    acc_dt = torch.promote_types(x.dtype, torch.float32)
    acc = torch.zeros((children.shape[0], x.shape[1]), dtype=acc_dt,
                      device=x.device)
    zero = torch.zeros((), dtype=acc_dt, device=x.device)
    for c in range(children.shape[1]):
        acc = acc + torch.where((c < cnt)[:, None],
                                x.index_select(0, children[:, c]).to(acc_dt),
                                zero)
    return acc


def ell_pool_mean(x, trace, children, counts):
    """Mean of each coarse vertex's children; empty rows give 0."""
    s = _pool_sum(x, children, counts)
    return (s / torch.clamp(counts.to(s.dtype), min=1.0)[:, None]).to(x.dtype)


def ell_pool_max(x, trace, children, counts):
    """Max of each coarse vertex's children; empty rows give 0. A later
    child replaces the running max only when strictly greater, so ties go
    to the lowest child slot (the argmax the training slice will route
    gradients to)."""
    cnt = counts.to(torch.int32)
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    acc = neg.expand(children.shape[0], x.shape[1])
    for c in range(children.shape[1]):
        cand = torch.where((c < cnt)[:, None],
                           x.index_select(0, children[:, c]), neg)
        acc = torch.where(cand > acc, cand, acc)
    return torch.where((cnt > 0)[:, None], acc, acc.new_zeros(()))


def ell_unpool(x, trace, children, counts):
    """out[f] = x[trace[f]]: every fine vertex copies its coarse row."""
    return x.index_select(0, trace)
