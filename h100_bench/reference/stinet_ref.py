"""Plain PyTorch reference of SurfaceTextureInpaintingNet, the model of the
benchmark's configuration, written from the published description and
the reference config's arch arguments.

It imports nothing of the program and takes nothing the program made: it
reads a room's COO edge lists, traces and dilated sets as the traffic
generator (or the room's file) gives them, in the room's own vertex
order, with no padding, tables, buckets or reordering.

    block(x)  = shortcut(x) + ELU(InstanceNorm(EdgeConv(x)))
    EdgeConv  : out_i = Lin2( mean_{e: dst_e = i} ReLU(Lin1(h_e)) ),
                h_e = [x_i, x_j - x_i]  (j = src_e),  or x_j - x_i for the
                translation-invariant first conv ("edgeconvtransinv")
    encoder   : max over each coarse vertex's fine vertices (the trace),
                then a block on the coarse level's edges
    bottleneck: blocks at the coarsest level, on its edges (dilation 1)
                or on the dilated edge set of that distance
    decoder   : each fine vertex copies its coarse vertex, then a block
    head      : Lin -> InstanceNorm -> ELU -> Lin -> tanh

Departure from a literal per-edge MLP: Lin2 is applied after the mean,
which is the same map for every vertex with an in-edge (Lin2 is affine and
the mean's weights sum to 1); no room here has a vertex without one.

`precision` says how the operands of every matmul are rounded before an
f32 product (TF32 off): "f32" not at all; "fp8" to float8 e4m3 with one
scale a tensor, the product rounded so too. The reference itself runs
"f32"; float8 is the control that the comparison has to fail.
"""
import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-5
FP8_MAX = 448.0     # largest finite float8 e4m3fn


@contextlib.contextmanager
def full_f32():
    """Matmuls in full f32 inside the block (TF32 off); restored after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def round_operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return t
    if precision == "fp8":
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32)
        # straight-through: the rounding has no gradient of its own
        return t + (q * scale - t).detach()
    raise ValueError(f"precision {precision!r}")


def linear(x, weight, bias, precision):
    out = F.linear(round_operand(x, precision),
                   round_operand(weight, precision), bias)
    # float8 holds the products too, as a model computing in it would
    return round_operand(out, precision)


def block_widths(args: dict):
    """[(group, index, dim_in, dim_out, first)] in the forward's order,
    from the config's arch arguments."""
    ngf, L = int(args["ngf"]), int(args["n_levels"])
    reps = int(args.get("n_repeated_io_convs", 1))
    nc = int(args["input_nc"])
    out = []
    for i in range(reps):
        out.append(("input_blocks", i, nc, ngf if i == reps - 1 else nc,
                    i == 0))
    for i in range(L):
        out.append(("encoder_blocks", i, ngf * 2 ** i, ngf * 2 ** (i + 1),
                    False))
    for i in range(int(args["n_blocks"])):
        out.append(("bottleneck_blocks", i, ngf * 2 ** L, ngf * 2 ** L,
                    False))
    for i in range(L):
        w = ngf * 2 ** (L - i)
        out.append(("decoder_blocks", i, w, w // 2, False))
    for i in range(reps):
        out.append(("output_blocks", i, ngf, ngf, False))
    return out


def param_shapes(args: dict) -> Dict[str, tuple]:
    """{name: shape} of every weight, in the published state-dict layout
    (`<group>.<i>.first_filter.nn.0.weight`, ..., `final_linear2.bias`)."""
    if args["filter_type"] not in ("edgeconv", "edgeconvtransinv"):
        raise NotImplementedError(args["filter_type"])
    if args.get("norm", "instance") != "instance" or args.get(
            "use_label_embedding"):
        raise NotImplementedError("instance norm, no label embedding")
    shapes = {}
    trans_inv = args["filter_type"] == "edgeconvtransinv"
    for group, i, cin, cout, first in block_widths(args):
        p = f"{group}.{i}."
        fan = cin if (trans_inv and first) else 2 * cin
        shapes[p + "first_filter.nn.0.weight"] = (2 * cout, fan)
        shapes[p + "first_filter.nn.0.bias"] = (2 * cout,)
        shapes[p + "first_filter.nn.2.weight"] = (cout, 2 * cout)
        shapes[p + "first_filter.nn.2.bias"] = (cout,)
        if cin != cout:
            shapes[p + "shortcut.weight"] = (cout, cin)
            shapes[p + "shortcut.bias"] = (cout,)
    ngf = int(args["ngf"])
    shapes["final_linear1.weight"] = (ngf, ngf)
    shapes["final_linear1.bias"] = (ngf,)
    shapes["final_linear2.weight"] = (int(args["output_nc"]), ngf)
    shapes["final_linear2.bias"] = (int(args["output_nc"]),)
    return shapes


def instance_norm(x):
    mean = x.mean(0)
    var = (x - mean).square().mean(0)
    return (x - mean) * torch.rsqrt(var + EPS)


def edge_conv(W, prefix, x, src, dst, num_vertices, trans_inv, precision):
    """EdgeConv with a mean over each receiver's in-edges."""
    w1, b1 = W[prefix + "nn.0.weight"], W[prefix + "nn.0.bias"]
    xi, xj = x.index_select(0, dst), x.index_select(0, src)
    h = (xj - xi) if trans_inv else torch.cat([xi, xj - xi], dim=1)
    agg = x.new_zeros((num_vertices, w1.shape[0])).index_add(
        0, dst, torch.relu(linear(h, w1, b1, precision)))
    deg = torch.bincount(dst, minlength=num_vertices).to(x.dtype)
    agg = agg / deg.clamp(min=1.0)[:, None]
    return linear(agg, W[prefix + "nn.2.weight"], W[prefix + "nn.2.bias"],
                  precision)


def graph_block(W, prefix, x, src, dst, num_vertices, trans_inv, precision):
    out = edge_conv(W, prefix + "first_filter.", x, src, dst, num_vertices,
                    trans_inv, precision)
    out = F.elu(instance_norm(out))
    if prefix + "shortcut.weight" in W:
        x = linear(x, W[prefix + "shortcut.weight"],
                   W[prefix + "shortcut.bias"], precision)
    return x + out


class RoomTensors:
    """A room's hierarchy as device tensors: per level its vertex count
    and (src, dst); traces; the coarsest level's dilated sets."""

    def __init__(self, num_vertices: Sequence[int], edges: List,
                 traces: List, dilated: Dict[int, object], device):
        def t(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)
        self.num_vertices = [int(v) for v in num_vertices]
        self.edges = [(t(e[0]), t(e[1])) for e in edges]
        self.traces = [t(tr) for tr in traces]
        self.dilated = {int(d): (t(e[0]), t(e[1])) for d, e in dilated.items()}


def forward(W: Dict[str, torch.Tensor], args: dict, room: RoomTensors,
            x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The model's [V_0, output_nc] output in the room's vertex order."""
    L = int(args["n_levels"])
    trans_inv = args["filter_type"] == "edgeconvtransinv"
    dilations = [int(d) for d in args.get("dilations")
                 or [1] * int(args["n_blocks"])]
    nv = room.num_vertices
    out = x
    for group, i, _, _, first in block_widths(args):
        p = f"{group}.{i}."
        if group == "input_blocks" or group == "output_blocks":
            lvl, edges = 0, room.edges[0]
        elif group == "encoder_blocks":
            lvl = i + 1
            idx = room.traces[i][:, None].expand(-1, out.shape[1])
            out = out.new_zeros((nv[lvl], out.shape[1])).scatter_reduce(
                0, idx, out, "amax", include_self=False)
            edges = room.edges[lvl]
        elif group == "bottleneck_blocks":
            lvl, d = L, dilations[i]
            edges = room.dilated[d] if d > 1 else room.edges[L]
        else:
            lvl = L - i - 1
            out = out.index_select(0, room.traces[lvl])
            edges = room.edges[lvl]
        out = graph_block(W, p, out, edges[0], edges[1], nv[lvl],
                          trans_inv and first, precision)
    out = linear(out, W["final_linear1.weight"], W["final_linear1.bias"],
                 precision)
    out = F.elu(instance_norm(out))
    return torch.tanh(linear(out, W["final_linear2.weight"],
                             W["final_linear2.bias"], precision))
