"""GraphSegmentationTrainer: ScanNet 21-class semantic segmentation with
SingleConvMeshNet, the counterpart of the concatenated layout of
`stinet_tpu/trainers/segmentation.py` (the reference's
segmentation_trainer.py).

The class-weighted cross entropy with ignore_index 0 over the valid
vertices; its gradient is that of the weighted sum divided by
max(weight total, 1e-8), which does not depend on the parameters.
Gradient accumulation (`num_cumulated_train_batches`) goes through
`graph_common._TrainStep`. Each step's confusion matrix is added on the
device into an exact running matrix (`metrics/iou.py`), which gives the
epoch's `mean_iou`. Training is on crops; validation is on full scenes, with
the val loss, `mean_iou`, `mean_precision`, `overall_accuracy`, per-class
IoU scalars, and `full_scene_mean_iou` from the predictions projected back
to the original vertices through `original_index_traces` when a batch
holds one scene. Checkpoints hold the model's state dict (its running
statistics are buffers), the optimizer state and the accumulation state,
and resume.

The model runs on an explicit `torch.device`, the card unless the caller
asks for the CPU; its weights are drawn from a `torch.Generator` seeded
from the config's `seed`, and f32 matmuls run with TF32 off, as the JAX f32
model's do. Batches reach the device through `iter_placed`. The loaders
are advanced as the JAX trainer's parameter-template probe advances them
(`graph_common.skip_probe`), so the batches are the JAX trainer's.

Not ported here: `make_stacked_segmentation_steps`, the scan over the
scenes of a stacked batch, which goes with stacked training (ROADMAP.md,
Queue 1 item 5).
"""
import time

import numpy as np
import torch

from stinet_tpu_torch.core.registry import DATALOADERS, TRAINERS
from stinet_tpu_torch.data.scannetlabel import CLASS_LABELS, CLASS_WEIGHTS
from stinet_tpu_torch.metrics import MetricTracker
from stinet_tpu_torch.metrics.iou import IoU, confusion_matrix_update
from stinet_tpu_torch.models.losses import cse_loss_terms
from stinet_tpu_torch.models.singleconvmeshnet import SingleConvMeshNet
from stinet_tpu_torch.serving import full_f32_matmuls, resolve_device
from stinet_tpu_torch.trainers.base import SingleModelTrainer
from stinet_tpu_torch.trainers.graph_common import (
    _TrainStep, build_optimizer, host_metrics, iter_placed, skip_probe,
    step_lr, vertex_mask)
from stinet_tpu_torch.trainers.inpainting3d import (
    _timed, check_nan_in_params)


def make_segmentation_steps(model, optimizer, class_weights, num_classes,
                            accumulate=1):
    """(train_step, eval_step) over graphs already on the model's device.

    train_step(graph, lr) -> ({"loss"}, confusion matrix): one forward,
    the weighted cross entropy and one backward, then one optimizer step
    at `lr` every `accumulate` calls (`_TrainStep`).
    eval_step(graph) -> ({"loss"}, predictions, confusion matrix), without
    gradients and on the running statistics. The matrices count the valid
    vertices whose label is not 0, as int64 on the device."""
    def loss_of(graph):
        vmask = vertex_mask(graph)
        logits = model(graph)
        wsum, wnorm = cse_loss_terms(logits, graph.labels,
                                     weights=class_weights, ignore_index=0,
                                     valid_mask=vmask)
        return wsum / torch.clamp(wnorm, min=1e-8), (logits, vmask)

    def confusion(graph, logits, vmask):
        pred = logits.argmax(-1)
        return pred, confusion_matrix_update(
            pred, graph.labels, num_classes,
            vmask * (graph.labels != 0).to(vmask.dtype))

    def metrics_of(graph, loss, aux):
        return {"loss": loss}, confusion(graph, *aux)[1]

    def eval_step(graph):
        model.eval()
        with full_f32_matmuls(), torch.no_grad():
            loss, aux = loss_of(graph)
            pred, conf = confusion(graph, *aux)
            return {"loss": loss}, pred, conf

    return (_TrainStep(model, optimizer, loss_of, accumulate, metrics_of),
            eval_step)


@TRAINERS.register("GraphSegmentationTrainer")
class GraphSegmentationTrainer(SingleModelTrainer):
    ARCH_KEY = "SingleConvMeshNet"
    MODEL_KEY = "seg"       # the checkpoint's dict key, as the JAX trainer's

    def __init__(self, config, device=None):
        super().__init__(config)
        logger = config.get_logger("train")
        self.device = resolve_device(
            device or getattr(config, "device", None) or "cuda")

        seed = config.get("seed", 123) or 123
        arch_args = dict(config["archs"][self.ARCH_KEY]["args"])
        self.model = SingleConvMeshNet(
            **arch_args, generator=torch.Generator().manual_seed(seed)
        ).to(self.device)
        self.num_classes = arch_args.get("num_classes", 21)
        logger.info("Number of parameters: %d",
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
        self.do_validation = tcfg.get("do_validation", True)
        self.batches_per_log = tcfg.get("batches_per_log", 1)

        self.class_weights = torch.as_tensor(
            CLASS_WEIGHTS[:self.num_classes], device=self.device)
        self._train_step, self._eval_step = make_segmentation_steps(
            self.model, self.optimizer, self.class_weights,
            self.num_classes, accumulate=self.num_accum)

        if config.resume is not None:
            self._resume_checkpoint(config.resume)

        self.train_metrics = MetricTracker("loss", writer=self.writer)
        self.valid_metrics = MetricTracker("loss", writer=self.writer)
        # per train epoch: {"epoch", "steps", "train_s", "wait_ms": the ms
        # each step waited for its batch}
        self.epoch_timings = []

    # ------------------------------------------------------------------
    def _train_epoch(self, epoch):
        check_nan_in_params(self.model, self.logger)
        self.train_metrics.reset()
        iou = IoU(self.num_classes, ignore_index=0)
        lr = self.lr_fn(epoch)
        loader = self.data_loader.train_loader
        len_epoch = len(loader)
        waits, steps = [], 0
        t0 = time.perf_counter()
        for batch_idx, (graph, names) in enumerate(_timed(
                iter_placed(loader, self.device), waits)):
            self.writer.set_step((epoch - 1) * len_epoch + batch_idx)
            metrics, conf = self._train_step(graph, lr)
            iou.add_matrix(conf)
            m = host_metrics(metrics)
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

        log = self.train_metrics.result(write=True)
        log["lr"] = float(lr)
        log["mean_iou"] = float(iou.value()[1])
        if self.do_validation:
            val_log = self._valid_epoch(epoch)
            log.update(**{"val_" + k: v for k, v in val_log.items()})
        return log

    def _full_scene_add(self, full_iou, name, pred):
        """Add one val scene's predictions, projected back to its original
        vertices through `original_index_traces`, to `full_iou`. Returns
        whether the scene had such a trace and labels of its length."""
        val_ds = self.data_loader.val_dataset
        try:
            sample = val_ds[list(val_ds.index2filenames).index(name)]
        except ValueError:
            return False
        orig = getattr(sample, "original_index_traces", None)
        if orig is None or sample.labels is None:
            return False
        orig = np.asarray(orig)
        labels = np.asarray(sample.labels)
        p_full = pred[orig]
        l_full = labels[:len(orig)] if len(labels) >= len(orig) else labels
        if len(l_full) != len(p_full):
            return False
        full_iou.add(p_full, l_full, (l_full != 0).astype(np.float32))
        return True

    def _valid_epoch(self, epoch):
        self.valid_metrics.reset()
        iou = IoU(self.num_classes, ignore_index=0)
        full_iou = IoU(self.num_classes, ignore_index=0)
        have_full = False
        for graph, names in iter_placed(self.data_loader.val_loader,
                                        self.device):
            metrics, pred, conf = self._eval_step(graph)
            iou.add_matrix(conf)
            for k, v in host_metrics(metrics).items():
                self.valid_metrics.update(k, v)
            # only a one-scene batch's rows project onto one scene
            if graph.num_graphs == 1:
                have_full |= self._full_scene_add(
                    full_iou, names[0], pred.cpu().numpy())
        log = self.valid_metrics.result(write=True)
        per_class, miou = iou.value()
        log["mean_iou"] = float(miou)
        log["mean_precision"] = float(iou.precision()[1])
        log["overall_accuracy"] = iou.overall_accuracy()
        if have_full:
            log["full_scene_mean_iou"] = float(full_iou.value()[1])
        for i, name in enumerate(CLASS_LABELS[:self.num_classes]):
            if not np.isnan(per_class[i]):
                self.writer.set_step(epoch - 1, f"iou_{name}", quiet=True)
                self.writer.add_scalar("per_class_iou", per_class[i])
        return log

    def _eval(self, mode):
        if self.config["vis"]:
            from stinet_tpu_torch.data.scannetlabel import SCANNET_COLOR_MAP
            from stinet_tpu_torch.utils.visualization import SemSegVisualizer
            vis = SemSegVisualizer(self.data_loader, SCANNET_COLOR_MAP,
                                   "visualizations/")
            for graph, names in iter_placed(self.data_loader.val_loader,
                                            self.device):
                _, pred, _ = self._eval_step(graph)
                n = int(graph.levels[0].num_vertices)
                vis.visualize_result(names[0], pred[:n].cpu().numpy(),
                                     graph.labels[:n].cpu().numpy())
        log = self._valid_epoch(0)
        for key, value in log.items():
            self.logger.info("    %-15s: %s", str(key), value)
