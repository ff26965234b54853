"""Inpainting3DTrainer: the flagship 3D surface-texture-inpainting
workload, the counterpart of `stinet_tpu/trainers/inpainting3d.py`.

Masked-composite forward with the optional 0.99^mask-weighted L1, gradient
accumulation (`num_cumulated_train_batches`), the stacked layout when the
loader's `stacked_batching` is set (the scenes of a batch run one by one,
`make_stacked_inpainting_steps`), per-batch metrics (loss, l1,
mse, graph_tv, graph_lap_var, psnr, psnr_mask_only, and the device memory
counters), full-scene validation, an eval mode, checkpoints in the JAX
package's dict layout with resume, and an epoch-stepped learning rate.

The model and its steps run on an explicit `torch.device`, the card unless
the caller asks for the CPU (`serving.resolve_device` raises when no card
is there). Its weights are drawn from a `torch.Generator` seeded from the
config's `seed`. Batches reach the device through `iter_placed`, so batch
i+1's copy overlaps step i. `impl` goes to the model, as in
`SceneInpainter`: None runs the CUDA kernels on a card, "plain" their plain
torch versions.

In a torch.distributed group of more than one rank (one process a card,
started by torchrun; parallel/multihost.py) the loader takes the stacked
layout and builds each rank's slice of every global batch, and the steps
sum their gradients, losses and metrics over the ranks
(`graph_common.maybe_data_mesh`); rank 0's weights and optimizer state are
broadcast at the start.

With `trainer.profile` (and not a dry run) an `utils/profiling.py:
EpochProfiler` traces the train steps its schedule picks into
`<log_dir>/profile`, stepped at the top of each train batch, as the 2D
trainer's; `train()` closes it at the end. The trace holds the program's
spans (`utils/profiling.py:span`: the loader's reads, transforms and
build stages, the placer's packing, the step's forward, backward,
optimizer and sync) beside the kernels.

The JAX trainer reads one batch at construction for its parameter
template, which advances the train loader's epoch key and shuffle by one
iteration. The port needs no template, but advances the loader the same
way (`graph_common.skip_probe`), so its batches are the JAX trainer's.
"""
import time

import torch

import stinet_tpu_torch.data.scannet  # noqa: F401  (registers the loader)
from stinet_tpu_torch.core.registry import DATALOADERS, TRAINERS
from stinet_tpu_torch.graph.hierarchy import scene_of
from stinet_tpu_torch.metrics import MetricTracker
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.serving import resolve_device
from stinet_tpu_torch.trainers.base import SingleModelTrainer
from stinet_tpu_torch.trainers.graph_common import (
    CONCATENATED_REFUSAL, build_optimizer, host_metrics, iter_placed,
    make_inpainting_steps, make_stacked_inpainting_steps, maybe_data_mesh,
    replicate_to_mesh, skip_probe, step_lr)
from stinet_tpu_torch.utils.profiling import (
    EpochProfiler, device_memory_stats)

METRICS = ("loss", "l1", "mse", "graph_tv", "graph_lap_var", "psnr",
           "psnr_mask_only", "mem_allocated", "mem_reserved")


def check_nan_in_params(model, logger=None):
    """NaN/inf parameter scan at each epoch's start, in one device sync."""
    names, params = zip(*model.named_parameters())
    finite = torch.stack([torch.isfinite(p).all() for p in params]).tolist()
    for name, ok in zip(names, finite):
        if not ok:
            msg = f"NaN/inf detected in parameter {name}"
            if logger:
                logger.error(msg)
            raise FloatingPointError(msg)


def _timed(batches, waits):
    """Iterate `batches`, appending the ms each item took to arrive."""
    it = iter(batches)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            waits.append((time.perf_counter() - t0) * 1e3)
            yield item
    finally:
        getattr(it, "close", lambda: None)()


@TRAINERS.register("Inpainting3DTrainer")
class Inpainting3DTrainer(SingleModelTrainer):
    ARCH_KEY = "SurfaceTextureInpaintingNet"
    MODEL_KEY = "graph"     # the checkpoint's dict key, as the JAX trainer's

    def __init__(self, config, device=None, impl=None):
        super().__init__(config)
        logger = config.get_logger("train")
        self.device = resolve_device(
            device or getattr(config, "device", None) or "cuda")

        seed = config.get("seed", 123) or 123
        arch_args = dict(config["archs"][self.ARCH_KEY]["args"])
        self.model = define_G(
            **arch_args, generator=torch.Generator().manual_seed(seed)
        ).to(self.device)
        logger.info("Number of parameters in graph: %d",
                    sum(p.numel() for p in self.model.parameters()))

        self.data_loader = config.init_obj_with_config(
            "data_loader", DATALOADERS)
        skip_probe(self.data_loader)

        dl_args = config["data_loader"]["args"]
        self.num_accum = int(dl_args.get("num_cumulated_train_batches", 1))
        self.optimizer, self.base_lr = build_optimizer(
            self.model.parameters(), config["optimizer"])
        self.lr_fn = step_lr(self.base_lr, config.get("lr_scheduler", {}))

        tcfg = config["trainer"]
        self.use_mask_weighted_loss = tcfg.get("use_mask_weighted_loss", False)
        self.do_validation = tcfg.get("do_validation", True)
        self.batches_per_log = tcfg.get("batches_per_log", 1)
        self.profiler = None
        if tcfg.get("profile", False) and not config.dry_run:
            self.profiler = EpochProfiler(config.log_dir / "profile")

        # the loader decides the layout, the trainer follows
        self._stacked = bool(getattr(self.data_loader, "stacked", False))
        self._mesh = maybe_data_mesh(config.config, self.device, logger)
        if self._stacked:
            self._train_step, self._eval_step = make_stacked_inpainting_steps(
                self.model, self.optimizer, self.use_mask_weighted_loss,
                impl=impl, accumulate=self.num_accum, mesh=self._mesh)
        elif self._mesh is not None:
            raise NotImplementedError(CONCATENATED_REFUSAL)
        else:
            self._train_step, self._eval_step = make_inpainting_steps(
                self.model, self.optimizer, self.use_mask_weighted_loss,
                impl=impl, accumulate=self.num_accum)

        if config.resume is not None:
            self._resume_checkpoint(config.resume)
        replicate_to_mesh(self._mesh, self.model, self.optimizer)

        self.train_metrics = MetricTracker(*METRICS, writer=self.writer)
        self.valid_metrics = MetricTracker(*METRICS, writer=self.writer)
        # per train epoch: {"epoch", "steps", "train_s", "wait_ms": the ms
        # each step waited for its batch}
        self.epoch_timings = []

    def train(self):
        """The epoch loop; the profiler's open window, if any, is written
        at its end."""
        try:
            super().train()
        finally:
            if self.profiler is not None:
                self.profiler.close()

    # ------------------------------------------------------------------
    def _train_epoch(self, epoch):
        check_nan_in_params(self.model, self.logger)
        self.train_metrics.reset()
        lr = self.lr_fn(epoch)

        loader = self.data_loader.train_loader
        len_epoch = len(loader)
        waits, steps = [], 0
        t0 = time.perf_counter()
        for batch_idx, (graph, names) in enumerate(_timed(
                iter_placed(loader, self.device), waits)):
            self.writer.set_step((epoch - 1) * len_epoch + batch_idx)
            if self.profiler is not None:
                self.profiler.step()
            for k, v in device_memory_stats(self.device).items():
                self.train_metrics.update(k, v)
            m = host_metrics(self._train_step(graph, lr))
            for k, v in m.items():
                self.train_metrics.update(k, v)
            steps += 1
            if batch_idx % self.batches_per_log == 0:
                self.logger.debug(
                    ":Train Epoch: %s %s I Loss: %.6f Names: %s", epoch,
                    self._progress(batch_idx, len_epoch), m["loss"], names)
        self.epoch_timings.append({
            "epoch": epoch, "steps": steps,
            "train_s": time.perf_counter() - t0, "wait_ms": waits})

        self.writer.set_step(epoch - 1, "epoch_train", quiet=True)
        log = self.train_metrics.result(write=True)
        log["lr"] = float(lr)
        if self.do_validation:
            val_log = self._valid_epoch(epoch)
            log.update(**{"val_" + k: v for k, v in val_log.items()})
        return log

    def _valid_epoch(self, epoch):
        self.valid_metrics.reset()
        loader = self.data_loader.val_loader
        len_epoch = len(loader)
        for batch_idx, (graph, names) in enumerate(
                iter_placed(loader, self.device)):
            self.writer.set_step((epoch - 1) * len_epoch + batch_idx, "valid")
            metrics, _ = self._eval_step(graph)
            for k, v in host_metrics(metrics).items():
                self.valid_metrics.update(k, v)
        self.writer.set_step(epoch - 1, "epoch_valid", quiet=True)
        return self.valid_metrics.result(write=True)

    def _eval(self, mode):
        loader = (self.data_loader.train_loader if mode == "train"
                  else self.data_loader.val_loader)
        self.valid_metrics.reset()
        visualizer = None
        if self.config["vis"]:
            from stinet_tpu_torch.utils.visualization import (
                ColorCompletionVisualizer)
            visualizer = ColorCompletionVisualizer(
                self.data_loader, "visualizations/")
        for graph, names in iter_placed(loader, self.device):
            metrics, composite = self._eval_step(graph)
            m = host_metrics(metrics)
            for k, v in m.items():
                self.valid_metrics.update(k, v, write=False)
            self.logger.info("    %s %-15s: %s", names[0], "loss", m["loss"])
            if visualizer is not None:
                # a stacked batch holds one scene a row
                rows = ([scene_of(graph, i) for i in range(len(names))]
                        if self._stacked else [graph])
                comps = composite if self._stacked else [composite]
                for name, g, comp in zip(names, rows, comps):
                    n = int(g.levels[0].num_vertices)
                    visualizer.visualize_result(
                        name, comp[:n].float().cpu().numpy() / 2.0 + 0.5,
                        g.color[:n].cpu().numpy() / 2.0 + 0.5,
                        g.mask[:n].cpu().numpy() > 0)
        for key, value in self.valid_metrics.result(write=False).items():
            self.logger.info("    %-15s: %s", str(key), value)
