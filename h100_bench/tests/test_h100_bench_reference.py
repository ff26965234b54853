"""The plain reference against the program's plain path on a small room:
the forward, and one train step; the weights' layout; the roundings of
the controls."""
import numpy as np
import pytest
import torch

from benchlib import cells, weights
from reference import stinet_ref, training_ref
from traffic import rooms


def _args(cfg):
    return cells.read_json(cells.BENCH_DIR / "configs" / f"{cfg}.json")[
        "config"]["archs"]["SurfaceTextureInpaintingNet"]["args"]


def _raw(room, sub):
    from stinet_tpu_torch.graph.build import RawHierarchy
    return RawHierarchy(x=sub.x, color=sub.color, mask=sub.mask,
                        num_vertices=list(room.num_vertices),
                        level_edges=room.edges, traces=room.traces,
                        dilated=room.dilated)


def _room_tensors(room):
    return stinet_ref.RoomTensors(room.num_vertices, room.edges, room.traces,
                                  room.dilated[2], "cpu")


def test_weights_have_the_programs_layout():
    from stinet_tpu_torch.models.factory import define_G
    args = _args("stinet-3d-bf16")
    model = define_G(**args)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert want == stinet_ref.param_shapes(args)
    w = weights.make(args, 5, torch.device("cpu"))
    model.load_state_dict(w)
    w2 = weights.make(args, 5, torch.device("cpu"))
    assert all(torch.equal(w[k], w2[k]) for k in w)
    b = w["bottleneck_blocks.0.first_filter.nn.0.weight"]
    assert float(b.abs().max()) <= 1 / np.sqrt(512)


def test_forward_matches_the_programs_plain_path():
    from stinet_tpu_torch.models.factory import define_G
    from stinet_tpu_torch.serving import SceneInpainter
    args = dict(_args("stinet-3d-bf16"), dtype=None)
    room = rooms.make_room(900, 11, 0)
    sub = rooms.make_submission(room, 11, 3)
    w = weights.make(args, 11, torch.device("cpu"))
    server = SceneInpainter(define_G(**args), w, device="cpu")
    got = server.predict(_raw(room, sub))
    with torch.no_grad():
        want = stinet_ref.forward(w, args, _room_tensors(room),
                                  torch.as_tensor(sub.x))
    assert got.shape == tuple(want.shape)
    assert np.abs(got - want.numpy()).max() < 1e-5


def test_one_train_step_matches_the_programs_plain_path():
    """The program's f32 step (plain path) against the reference: the loss,
    each leaf's gradient as Adam's first moment holds it, and the step."""
    from stinet_tpu_torch.graph.build import build_hierarchical_graph
    from stinet_tpu_torch.models.factory import define_G
    from stinet_tpu_torch.trainers import graph_common as gc
    args = dict(_args("stinet-3d-bf16"), dtype=None)
    room = rooms.make_room(800, 12, 1)
    sub = rooms.make_submission(room, 12, 1)
    w = weights.make(args, 12, torch.device("cpu"))
    model = define_G(**args)
    model.load_state_dict(w)
    opt = torch.optim.Adam(model.parameters(), lr=7e-5, amsgrad=True)
    step, _ = gc.make_inpainting_steps(model, opt, True)
    graph = build_hierarchical_graph([_raw(room, sub)], pad_multiple=512,
                                     geometric=True, windowed=True)
    loss = gc.host_metrics(step(graph, 7e-5))["loss"]
    sample = (room.num_vertices, room.edges, room.traces, room.dilated[2],
              sub.x, sub.color, sub.mask)
    losses, g1, w1, _ = training_ref.train(w, args, [sample], 7e-5, "cpu")
    assert loss == pytest.approx(losses[0], rel=1e-5)
    norms = {k: float(g.norm()) for k, g in g1.items()}
    med = float(np.median(list(norms.values())))
    for name, p in model.named_parameters():
        g = opt.state[p]["exp_avg"] / 0.1
        assert torch.allclose(g, g1[name], rtol=1e-3, atol=1e-6), name
        # Adam's first step is about lr * sign(g), so an element whose
        # gradient is near nought moves by its round-off: compare each
        # leaf's change by its norm, where the leaf's gradient is not
        # nought to rounding (a bias before an affine-free norm)
        if norms[name] >= 1e-3 * med:
            got = float((p.detach() - w[name]).norm())
            want = float((w1[name] - w[name]).norm())
            assert got == pytest.approx(want, rel=1e-2), name


def test_control_roundings():
    y = torch.linspace(-2, 2, 101)
    q = stinet_ref.round_operand(y, "fp8")
    err = (q - y).abs().max().item()
    assert 0 < err <= 2.0 / 448 * 32
    assert stinet_ref.round_operand(y, "f32") is y


def test_schedule_is_the_loaders():
    from stinet_tpu_torch.data.scannet import _SceneLoader

    class Names:
        def __len__(self):
            return 8
    loader = _SceneLoader(Names(), 1, shuffle=True, seed=1234)
    for epoch in range(3):
        idx = np.arange(8)
        loader._rng.shuffle(idx)
        assert training_ref.schedule(list("abcdefgh"), 1234, epoch) == \
            idx.tolist()
