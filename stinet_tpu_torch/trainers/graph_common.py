"""Training machinery of the graph models: the optimizer from a config's
`optimizer` block, the epoch -> learning-rate schedules, the inpainting
loss and metrics, the train / eval step factories with gradient
accumulation (over concatenated batches, and over stacked ones scene by
scene, across the ranks of a data mesh too), the data mesh of a
multi-process run, and the placement of a loader's batches on the device.

PyTorch counterpart of `stinet_tpu/trainers/graph_common.py`. The JAX
package writes torch's Adam(amsgrad=True) out by hand
(`scale_by_amsgrad_torch`); here it is `torch.optim.Adam(amsgrad=True)`
itself. The learning rate enters each step as an argument, as the JAX step
takes it, and the schedules return it per epoch (the reference steps its
scheduler once per epoch).
"""
from typing import Dict

import numpy as np
import torch

from stinet_tpu_torch.data.prefetch import PrefetchIterator
from stinet_tpu_torch.graph.hierarchy import HierarchicalGraph, scene_of
from stinet_tpu_torch.metrics import graph_metrics as gm
from stinet_tpu_torch.parallel import multihost
from stinet_tpu_torch.serving import PackedPlacer, full_f32_matmuls
from stinet_tpu_torch.utils.profiling import span


def build_optimizer(params, opt_config: Dict):
    """(optimizer, base lr) from the reference's config['optimizer'] block:
    Adam (with `amsgrad`, `betas`, `eps`, `weight_decay`) or SGD (with
    `momentum`, `nesterov`). torch's weight decay adds w * param to the
    gradient before the moments, as the JAX chain does."""
    args = dict(opt_config.get("args", {}))
    opt_type = opt_config.get("type", "Adam")
    lr = float(args.get("lr", 1e-3))
    wd = float(args.get("weight_decay", 0.0) or 0.0)
    if opt_type == "Adam":
        betas = tuple(args.get("betas", (0.9, 0.999)))
        return torch.optim.Adam(
            params, lr=lr, betas=betas, eps=float(args.get("eps", 1e-8)),
            weight_decay=wd, amsgrad=bool(args.get("amsgrad", False))), lr
    if opt_type == "SGD":
        return torch.optim.SGD(
            params, lr=lr, weight_decay=wd,
            momentum=float(args.get("momentum", 0.0) or 0.0),
            nesterov=bool(args.get("nesterov", False))), lr
    raise NotImplementedError(f"optimizer {opt_type!r}")


class FnLR:
    """Callable epoch -> lr; `observe()` is a no-op (stateless policies)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, epoch):
        return self._fn(epoch)

    def observe(self, value):
        pass


class PlateauLR:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics: `observe()`
    takes the monitored value once per epoch, `__call__(epoch)` returns the
    current lr. Defaults match torch."""

    def __init__(self, base_lr, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0,
                 min_lr=0.0, eps=1e-8):
        if mode not in ("min", "max") or threshold_mode not in ("rel",
                                                                "abs"):
            raise ValueError(f"mode {mode!r} / threshold_mode "
                             f"{threshold_mode!r}")
        self.lr = float(base_lr)
        self.mode, self.factor, self.patience = mode, factor, int(patience)
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.eps = int(cooldown), min_lr, eps
        self.best = np.inf if mode == "min" else -np.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, a):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < self.best * (1.0 - self.threshold)
            return a < self.best - self.threshold
        if self.threshold_mode == "rel":
            return a > self.best * (1.0 + self.threshold)
        return a > self.best + self.threshold

    def __call__(self, epoch):
        return self.lr

    def observe(self, value):
        if value is None:
            return
        value = float(value)
        if self._is_better(value):
            self.best = value
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0


def step_lr(base_lr: float, scheduler_config: Dict):
    """Epoch -> lr for the torch.optim.lr_scheduler policies a config can
    name. Epochs count from 1 and are queried at the epoch's start, so at
    epoch e the scheduler has stepped e - 1 times."""
    typ = scheduler_config.get("type", "StepLR")
    args = scheduler_config.get("args", {})
    if typ == "StepLR":
        step_size = int(args.get("step_size", 10**9))
        gamma = float(args.get("gamma", 1.0))
        return FnLR(lambda epoch: base_lr * gamma ** ((epoch - 1)
                                                      // step_size))
    if typ in ("ConstantLR", "None", None):
        return FnLR(lambda epoch: base_lr)
    if typ == "ExponentialLR":
        gamma = float(args.get("gamma", 1.0))
        return FnLR(lambda epoch: base_lr * gamma ** (epoch - 1))
    if typ == "CosineAnnealingLR":
        t_max = float(args["T_max"])
        eta_min = float(args.get("eta_min", 0.0))
        return FnLR(lambda epoch: eta_min + (base_lr - eta_min) * 0.5
                    * (1.0 + np.cos(np.pi * (epoch - 1) / t_max)))
    if typ == "LinearLR":
        start = float(args.get("start_factor", 1.0 / 3.0))
        end = float(args.get("end_factor", 1.0))
        total = int(args.get("total_iters", 5))
        return FnLR(lambda epoch: base_lr * (
            start + (end - start) * min(epoch - 1, total) / total))
    if typ == "ReduceLROnPlateau":
        return PlateauLR(base_lr, **{
            k: v for k, v in args.items()
            if k in ("mode", "factor", "patience", "threshold",
                     "threshold_mode", "cooldown", "min_lr", "eps")})
    raise NotImplementedError(f"lr scheduler {typ!r}")


def vertex_mask(graph: HierarchicalGraph):
    """[V0_pad] f32: 1 on the valid level-0 rows."""
    lvl0 = graph.levels[0]
    return gm.length_mask(lvl0.num_vertices, lvl0.num_padded_vertices,
                          graph.x.device)


def inpainting_loss_terms(output, color, mask, vmask, use_mask_weighted):
    """(wsum, n, composite) of the masked-composite L1: predictions replace
    colors only inside the mask (the reference's
    inpainting3d_trainer.py:127-137), |composite - color| with the optional
    0.99^mask distance weighting summed over the valid vertices (wsum),
    and their count times the channels (n)."""
    composite = torch.where(mask > 0, output, color).to(color.dtype)
    per = (composite - color).abs()
    if use_mask_weighted:
        per = per * torch.pow(0.99, mask)
    per = per * vmask[:, None]
    return per.sum(), vmask.sum() * color.shape[-1], composite


def inpainting_loss(output, color, mask, vmask, use_mask_weighted):
    """The masked-composite L1, a mean over valid vertices x channels.
    Returns (loss, composite), both f32."""
    wsum, n, composite = inpainting_loss_terms(output, color, mask, vmask,
                                               use_mask_weighted)
    return wsum / torch.clamp(n, min=1.0), composite


def inpainting_metrics(composite, graph: HierarchicalGraph, loss):
    """The step's metric dict, in f32."""
    composite = composite.to(torch.float32)
    lvl0 = graph.levels[0]
    vmask = vertex_mask(graph)
    region = (graph.mask[:, 0] > 0).to(torch.float32)
    tv, lap_var = gm.graph_tv_and_lap_var(composite, lvl0.edges,
                                          lvl0.num_vertices)
    return {
        "loss": loss,
        "l1": gm.l1(composite, graph.color, vmask),
        "mse": gm.mse(composite, graph.color, vmask),
        "graph_tv": tv,
        "graph_lap_var": lap_var,
        "psnr": gm.psnr(composite, graph.color, vmask, data_range=2.0),
        "psnr_mask_only": gm.masked_psnr(composite, graph.color, vmask,
                                         region, data_range=2.0),
    }


def set_lr(optimizer, lr) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def mesh_sum(mesh, t):
    """t summed over the ranks of `mesh` (a new tensor); t itself without
    a mesh."""
    return t if mesh is None else mesh.all_reduce_(t.detach().clone())


class _MeshGrads:
    """Hold the parameters' gradients aside before a call's backward, then
    sum the call's fresh gradients over the ranks of the mesh (one
    all_reduce of one flat buffer) and add them to what was held. Each
    call's gradients are summed as JAX's mesh step psums them, so a
    partial accumulation is the same on every rank, and rank 0's
    checkpoint of it holds the global sum. Does nothing without a mesh."""

    def __init__(self, mesh, model):
        self.mesh, self.model = mesh, model

    def hold(self):
        if self.mesh is None:
            return None
        held = []
        for p in self.model.parameters():
            held.append(p.grad)
            p.grad = None
        return held

    def reduce(self, held):
        if self.mesh is None:
            return
        params = list(self.model.parameters())
        self.mesh.all_reduce_grads(params)
        for p, h in zip(params, held):
            if h is not None:
                p.grad = h if p.grad is None else h + p.grad


class _TrainStep:
    """train_step(graph, lr) -> what `metrics_of` returns, with gradient
    accumulation over `accumulate` calls. `loss_of(graph)` gives (loss,
    aux); each call backpropagates loss / accumulate into the parameters'
    gradients, and every accumulate-th call takes one optimizer step at
    its `lr` and clears them (optax.MultiSteps, which the JAX trainers
    use, steps on the mean of the gradients; this is the same sum). The
    partial sum carries over from call to call, so over an epoch's end as
    well; `state` and `load_state` hold it for checkpoints. The result is
    `metrics_of(graph, loss, aux)`, taken without gradients. With a data
    `mesh` each call's fresh gradients are summed over its ranks
    (`_MeshGrads`), so `loss_of` gives this rank's share of the global
    loss."""

    def __init__(self, model, optimizer, loss_of, accumulate, metrics_of,
                 mesh=None):
        self.model, self.optimizer = model, optimizer
        self.loss_of, self.accumulate = loss_of, int(accumulate)
        self.metrics_of = metrics_of
        self.mini_step = 0
        self.mesh = mesh
        self._grads = _MeshGrads(mesh, model)

    def __call__(self, graph, lr):
        self.model.train()
        with full_f32_matmuls():
            if self.mini_step == 0:
                self.optimizer.zero_grad(set_to_none=True)
            loss, aux = self._backward(graph, lr)
            self.mini_step = (self.mini_step + 1) % self.accumulate
            if self.mini_step == 0:
                with span("step.optimizer"):
                    set_lr(self.optimizer, lr)
                    self.optimizer.step()
            with torch.no_grad():
                return self.metrics_of(graph, loss.detach(), aux)

    def _loss(self, graph, lr):
        """(loss, aux) of one call at learning rate `lr`: `loss_of(graph)`
        (a subclass may step other models here first)."""
        return self.loss_of(graph)

    def _backward(self, graph, lr):
        """The call's loss / accumulate backpropagated into the gradients;
        returns (loss, aux)."""
        held = self._grads.hold()
        with span("step.forward"):
            loss, aux = self._loss(graph, lr)
        with span("step.backward"):
            (loss / self.accumulate if self.accumulate > 1
             else loss).backward()
        self._grads.reduce(held)
        return loss, aux

    def state(self):
        """{"mini_step": calls since the last optimizer step, "grads":
        {parameter name: its partial gradient sum}} (no grads at 0)."""
        grads = {}
        if self.mini_step:
            grads = {k: p.grad.detach().clone()
                     for k, p in self.model.named_parameters()
                     if p.grad is not None}
        return {"mini_step": self.mini_step, "grads": grads}

    def load_state(self, state):
        self.mini_step = int(state["mini_step"])
        if self.mini_step >= self.accumulate:
            raise ValueError(f"{self.mini_step} accumulated calls saved, "
                             f"the optimizer steps every {self.accumulate}")
        for k, p in self.model.named_parameters():
            g = state["grads"].get(k)
            p.grad = None if g is None else g.to(p.device, p.dtype).clone()


def make_inpainting_steps(model, optimizer, use_mask_weighted, impl=None,
                          accumulate=1):
    """(train_step, eval_step) over graphs already on the model's device.

    train_step(graph, lr) -> metrics: one forward, the loss and one
    backward, then one optimizer step at learning rate `lr` every
    `accumulate` calls (`_TrainStep`); eval_step(graph) -> (metrics,
    composite) without gradients. Metrics are detached 0-d tensors, so a
    step does not wait for the device. f32 matmuls run in full f32 (TF32
    off), as the JAX f32 model's do; `impl` is passed to the model (None:
    kernels on a CUDA graph)."""
    def loss_of(graph):
        out = model(graph, impl=impl)
        return inpainting_loss(out, graph.color, graph.mask,
                               vertex_mask(graph), use_mask_weighted)

    def eval_step(graph):
        model.eval()
        with full_f32_matmuls(), torch.no_grad():
            loss, composite = loss_of(graph)
            return inpainting_metrics(composite, graph, loss), composite

    def metrics_of(graph, loss, composite):
        return inpainting_metrics(composite.detach(), graph, loss)

    return (_TrainStep(model, optimizer, loss_of, accumulate, metrics_of),
            eval_step)


class _StackedTrainStep(_TrainStep):
    """The train step over a stacked batch: each scene's forward and
    backward in turn, so one scene's activations are alive at a time.
    `loss_of(scene)` gives (wsum, n, composite); the gradient that reaches
    the parameters is sum_b grad(wsum_b) / sum_b n_b / accumulate, the
    concatenated batch's up to summation order (n does not depend on the
    parameters, so sum_b n_b is taken from the vertex counts first).

    With a data `mesh` (parallel/mesh.py:ProcessMesh) each rank holds its
    slice of the global batch: n is summed over the ranks before the
    backward, each rank's scenes are scaled by that global n, the call's
    gradients are summed over the ranks in one all_reduce (`_MeshGrads`),
    and every rank takes the same optimizer step."""

    def _backward(self, graph, lr):
        scenes = [scene_of(graph, i) for i in range(graph.x.shape[0])]
        n = torch.clamp(mesh_sum(self.mesh, sum(
            vertex_mask(g).sum() for g in scenes) * graph.color.shape[-1]),
            min=1.0)
        held = self._grads.hold()
        wsum, composites = 0.0, []
        for g in scenes:
            with span("step.forward"):
                w, _, composite = self.loss_of(g)
            with span("step.backward"):
                (w / (n * self.accumulate)).backward()
            wsum = wsum + w.detach()
            composites.append(composite.detach())
        self._grads.reduce(held)
        return mesh_sum(self.mesh, wsum) / n, torch.stack(composites)


def _stacked_metrics(graph, loss, composite, mesh=None):
    """Per-scene metrics averaged with the scenes' valid-vertex counts as
    weights; "loss" is the batch's exact loss. PSNRs are per scene before
    the average, as in JAX's stacked step (a monitoring difference from
    the concatenated layout's). With a data mesh the weighted sums and the
    weights are summed over the ranks first (one all_reduce)."""
    sums, total = {}, 0.0
    for i in range(composite.shape[0]):
        g = scene_of(graph, i)
        w = vertex_mask(g).sum()
        for k, v in inpainting_metrics(composite[i], g, loss).items():
            sums[k] = sums.get(k, 0.0) + v * w
        total = total + w
    if mesh is not None:
        flat = mesh_sum(mesh, torch.stack(
            [sums[k].to(torch.float32) for k in sums]
            + [total.to(torch.float32)]))
        sums, total = dict(zip(sums, flat[:-1])), flat[-1]
    out = {k: v / torch.clamp(total, min=1.0) for k, v in sums.items()}
    out["loss"] = loss
    return out


def make_stacked_inpainting_steps(model, optimizer, use_mask_weighted,
                                  impl=None, accumulate=1, mesh=None):
    """(train_step, eval_step) over stacked graphs (graph/build.py
    `build_stacked_graph`) already on the model's device, the counterpart
    of stinet_tpu/trainers/graph_common.py:make_stacked_inpainting_steps:
    a loop over the scenes, each scene's gradient of its weighted sum
    accumulated, one optimizer step on their sum over the batch's
    valid-vertex count (`_StackedTrainStep`); loss sum wsum / sum n;
    metrics per scene, averaged with valid-vertex weights.
    eval_step(graph) -> (metrics, [B, V_pad, 3] composites). With a data
    `mesh` each rank passes its slice of the global batch, and the sums
    (gradients, wsum, n, the metrics' weighted sums) run over the ranks,
    as JAX's shard_map psums them. Batch-norm models are refused, as in
    JAX: per-scene batch statistics would differ from the batch's."""
    if any(getattr(m, "norm_type", None) == "batch" for m in model.modules()):
        raise ValueError("stacked batching does not support batch-norm "
                         "models (per-scene batch statistics would diverge);"
                         " use the concatenated layout")

    def loss_of(graph):
        out = model(graph, impl=impl)
        return inpainting_loss_terms(out, graph.color, graph.mask,
                                     vertex_mask(graph), use_mask_weighted)

    def metrics_of(graph, loss, composite):
        return _stacked_metrics(graph, loss, composite, mesh)

    def eval_step(graph):
        model.eval()
        with full_f32_matmuls(), torch.no_grad():
            terms = [loss_of(scene_of(graph, i))
                     for i in range(graph.x.shape[0])]
            loss = (mesh_sum(mesh, sum(w for w, _, _ in terms))
                    / torch.clamp(mesh_sum(mesh, sum(n for _, n, _ in terms)),
                                  min=1.0))
            composite = torch.stack([c for _, _, c in terms])
            return metrics_of(graph, loss, composite), composite

    return (_StackedTrainStep(model, optimizer, loss_of, accumulate,
                              metrics_of, mesh), eval_step)


# --- data parallelism across processes ---------------------------------------
# The reference's `n_gpu` key (asserted to 1 there). A torch process drives
# one card, so the port's data mesh is the torch.distributed process group
# (parallel/mesh.py:ProcessMesh, one rank a card, started by torchrun); each
# rank's loader builds its slice of every global stacked batch.

CONCATENATED_REFUSAL = (
    "concatenated batch graphs are single-process only; use stacked "
    "batching across processes (the data loader's stacked_batching, which "
    "a group of more than one rank forces)")


def maybe_data_mesh(config_dict, device, logger=None):
    """The data mesh of a run: in a torch.distributed group of more than
    one rank, the group's `ProcessMesh` on `device`; else None. In one
    process an `n_gpu` above 1 is logged and ignored: a torch process
    drives one card, and a run across cards is one process a card under
    torchrun (JAX's one-process mesh of several devices has no torch
    counterpart)."""
    if multihost.process_count() > 1:
        from stinet_tpu_torch.parallel.mesh import ProcessMesh
        mesh = ProcessMesh(device)
        if logger is not None:
            logger.info("Data parallelism: %d processes, this one rank %d on "
                        "%s", mesh.n_parts, mesh.rank, mesh.device)
        return mesh
    n_req = int(config_dict.get("n_gpu", 1) or 1)
    if n_req > 1 and logger is not None:
        logger.warning(
            "n_gpu=%d in one process: a torch process drives one card, so "
            "this run uses one. Start one process a card with torchrun "
            "(python -m torch.distributed.run --nproc_per_node %d -m "
            "stinet_tpu_torch.train -c <config>)", n_req, n_req)
    return None


def replicate_to_mesh(mesh, model, optimizer=None):
    """Rank 0's parameters, buffers and optimizer state on every rank
    (broadcasts, in place); nothing without a mesh."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            mesh.broadcast_(t.data)
        if optimizer is not None:
            for state in optimizer.state.values():
                for v in state.values():
                    if isinstance(v, torch.Tensor):
                        mesh.broadcast_(v)


def place_stacked(mesh, stacked, device=None):
    """A stacked batch on the device (the mesh's, else `device`). Across
    processes each rank passes its own slice of the global batch, which its
    loader built (data/scannet.py), as each JAX host passes its local one."""
    return stacked.to(mesh.device if mesh is not None else device)


def place_graph_on_mesh(mesh, graph, device=None):
    """A concatenated batch on the device (the mesh's, else `device`).
    Raises NotImplementedError in a group of more than one rank: a
    concatenated graph's vertex ids and counts are the batch's, so it
    cannot be split across processes (JAX's global_graph_from_local)."""
    if mesh is not None and mesh.n_parts > 1:
        raise NotImplementedError(CONCATENATED_REFUSAL)
    return graph.to(mesh.device if mesh is not None else device)


def skip_probe(data_loader):
    """Advance a trainer's loaders as the JAX trainers' parameter-template
    probe does: the train loader by one iteration, and the val loader too
    when the train set is empty (`_SceneLoader.skip_epoch`)."""
    for loader in (data_loader.train_loader, data_loader.val_loader):
        loader.skip_epoch()
        if len(loader):
            return
    raise RuntimeError("No data available to initialize the model")


def host_metrics(metrics) -> Dict[str, float]:
    """A step's metric dict as Python floats, in ONE device-to-host copy:
    the host's wait for the card at a step's end."""
    with span("step.sync"):
        values = torch.stack([v.detach().to(torch.float32).reshape(())
                              for v in metrics.values()]).cpu().tolist()
    return dict(zip(metrics, values))


def _waited(it):
    """Iterate `it`, each wait for its next item in a "loop.wait" span
    named for the batch it brought."""
    while True:
        with span("loop.wait") as wait:
            try:
                item = next(it)
            except StopIteration:
                return
            wait.batch = item[1]
        yield item


def iter_placed(batches, device: torch.device, slots: int = 3):
    """Iterate (graph, names) pairs of host graphs with the graphs already
    on `device`.

    On a card a thread packs and copies batch i+1 on a copy stream while
    the caller's step i runs, through a `PackedPlacer` ring of `slots`
    buffers: the caller's stream waits for each copy before the batch is
    handed out, and a slot goes back to the ring only when the caller asks
    for the next batch, so its buffer is not refilled while a step still
    reads it. A yielded graph is valid until then. At most `slots` batches
    are placed at once (one in the caller's hands, `slots` - 2 queued, one
    in the placing thread). On a CPU device each graph is moved in the
    caller's thread. When the caller stops early, the placing thread and
    the loader's own prefetch (`batches`' iterator, where it has `close`)
    are stopped."""
    src = iter(batches)
    try:
        if device.type != "cuda":
            for graph, names in _waited(src):
                yield graph.to(device), names
            return
        placer = PackedPlacer(device, slots=slots,
                              stream=torch.cuda.Stream(device))

        def placed():
            for graph, names in src:
                with span("place.pack", names):
                    packed = placer.pack(graph)
                yield placer.put(packed), names, packed.slot

        it = PrefetchIterator(placed(), buffer_size=slots - 2)
        try:
            for graph, names, slot in _waited(it):
                placer.ready(slot)
                yield graph, names
                placer.release(slot)
        finally:
            it.close()
            # wake a placing thread parked on the ring; what it may still
            # copy waits on the device for the work enqueued so far
            for slot in range(slots):
                placer.release(slot)
    finally:
        getattr(src, "close", lambda: None)()
