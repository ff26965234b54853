"""Training machinery of the graph models: the optimizer from a config's
`optimizer` block, the epoch -> learning-rate schedules, the inpainting
loss and metrics, the train / eval step factory with gradient
accumulation, and the placement of a loader's batches on the device.

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
from stinet_tpu_torch.graph.hierarchy import HierarchicalGraph
from stinet_tpu_torch.metrics import graph_metrics as gm
from stinet_tpu_torch.serving import PackedPlacer, full_f32_matmuls


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


def inpainting_loss(output, color, mask, vmask, use_mask_weighted):
    """Masked-composite L1: predictions replace colors only inside the mask
    (the reference's inpainting3d_trainer.py:127-137), with the optional
    0.99^mask distance weighting; mean over valid vertices x channels.
    Returns (loss, composite), both f32."""
    composite = torch.where(mask > 0, output, color).to(color.dtype)
    per = (composite - color).abs()
    if use_mask_weighted:
        per = per * torch.pow(0.99, mask)
    per = per * vmask[:, None]
    n = torch.clamp(vmask.sum() * color.shape[-1], min=1.0)
    return per.sum() / n, composite


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


class _TrainStep:
    """train_step(graph, lr) -> what `metrics_of` returns, with gradient
    accumulation over `accumulate` calls. `loss_of(graph)` gives (loss,
    aux); each call backpropagates loss / accumulate into the parameters'
    gradients, and every accumulate-th call takes one optimizer step at
    its `lr` and clears them (optax.MultiSteps, which the JAX trainers
    use, steps on the mean of the gradients; this is the same sum). The
    partial sum carries over from call to call, so over an epoch's end as
    well; `state` and `load_state` hold it for checkpoints. The result is
    `metrics_of(graph, loss, aux)`, taken without gradients."""

    def __init__(self, model, optimizer, loss_of, accumulate, metrics_of):
        self.model, self.optimizer = model, optimizer
        self.loss_of, self.accumulate = loss_of, int(accumulate)
        self.metrics_of = metrics_of
        self.mini_step = 0

    def __call__(self, graph, lr):
        self.model.train()
        with full_f32_matmuls():
            if self.mini_step == 0:
                self.optimizer.zero_grad(set_to_none=True)
            loss, aux = self._loss(graph, lr)
            (loss / self.accumulate if self.accumulate > 1
             else loss).backward()
            self.mini_step = (self.mini_step + 1) % self.accumulate
            if self.mini_step == 0:
                set_lr(self.optimizer, lr)
                self.optimizer.step()
            with torch.no_grad():
                return self.metrics_of(graph, loss.detach(), aux)

    def _loss(self, graph, lr):
        """(loss, aux) of one call at learning rate `lr`: `loss_of(graph)`
        (a subclass may step other models here first)."""
        return self.loss_of(graph)

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
    """A step's metric dict as Python floats, in ONE device-to-host copy."""
    values = torch.stack([v.detach().to(torch.float32).reshape(())
                          for v in metrics.values()]).cpu().tolist()
    return dict(zip(metrics, values))


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
            for graph, names in src:
                yield graph.to(device), names
            return
        placer = PackedPlacer(device, slots=slots,
                              stream=torch.cuda.Stream(device))

        def placed():
            for graph, names in src:
                packed = placer.pack(graph)
                yield placer.put(packed), names, packed.slot

        it = PrefetchIterator(placed(), buffer_size=slots - 2)
        try:
            for graph, names, slot in it:
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
