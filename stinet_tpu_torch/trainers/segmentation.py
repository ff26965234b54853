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

With the loader's `stacked_batching` (forced in a torch.distributed group
of more than one rank) the trainer takes `make_stacked_segmentation_steps`:
the scenes of a stacked batch one by one, and across ranks each rank its
slice of the global batch, with the sums (gradients, losses, confusion
matrices, running statistics) over the ranks. A short val batch's tail
repeats weigh 0 (`_stacked_val_weights`), and the full-scene confusion is
summed across ranks.
"""
import time

import numpy as np
import torch

from stinet_tpu_torch.core.registry import DATALOADERS, TRAINERS
from stinet_tpu_torch.data.scannetlabel import CLASS_LABELS, CLASS_WEIGHTS
from stinet_tpu_torch.graph.hierarchy import scene_of
from stinet_tpu_torch.metrics import MetricTracker
from stinet_tpu_torch.metrics.iou import IoU, confusion_matrix_update
from stinet_tpu_torch.models.losses import cse_loss_terms, cse_row_weights
from stinet_tpu_torch.models.singleconvmeshnet import SingleConvMeshNet
from stinet_tpu_torch.parallel import multihost
from stinet_tpu_torch.serving import full_f32_matmuls, resolve_device
from stinet_tpu_torch.trainers.base import SingleModelTrainer
from stinet_tpu_torch.trainers.graph_common import (
    CONCATENATED_REFUSAL, _TrainStep, build_optimizer, host_metrics,
    iter_placed, maybe_data_mesh, mesh_sum, replicate_to_mesh, skip_probe,
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

    def metrics_of(graph, loss, aux):
        return {"loss": loss}, _confusion(graph, *aux, num_classes)[1]

    def eval_step(graph):
        model.eval()
        with full_f32_matmuls(), torch.no_grad():
            loss, aux = loss_of(graph)
            pred, conf = _confusion(graph, *aux, num_classes)
            return {"loss": loss}, pred, conf

    return (_TrainStep(model, optimizer, loss_of, accumulate, metrics_of),
            eval_step)


class _StackedSegTrainStep(_TrainStep):
    """The segmentation step over a stacked batch, scene by scene
    (`make_stacked_segmentation_steps`); across the ranks of a data
    `mesh`, each rank its slice of the batch."""

    def __init__(self, model, optimizer, scene_terms, accumulate,
                 row_weights, num_classes, mesh=None):
        super().__init__(model, optimizer, scene_terms, accumulate,
                         lambda graph, loss, conf: ({"loss": loss}, conf),
                         mesh)
        self.row_weights, self.num_classes = row_weights, num_classes

    def _backward(self, graph, lr):
        scenes = [scene_of(graph, i) for i in range(graph.x.shape[0])]
        # wnorm does not depend on the parameters: the global one first
        denom = torch.clamp(mesh_sum(self.mesh, sum(
            self.row_weights(g).sum() for g in scenes)), min=1e-8)
        stats = [b for b in self.model.buffers() if b.is_floating_point()]
        start = [b.detach().clone() for b in stats]
        new = [torch.zeros_like(b) for b in stats]
        held = self._grads.hold()
        wsum, conf = 0.0, 0
        for g in scenes:
            with torch.no_grad():
                for b, s in zip(stats, start):
                    b.copy_(s)
            w, c = self.loss_of(g)
            (w / (denom * self.accumulate)).backward()
            with torch.no_grad():
                for n, b in zip(new, stats):
                    n.add_(b)
            wsum, conf = wsum + w.detach(), conf + c
        self._grads.reduce(held)
        # each scene moved the statistics one step from the same start:
        # their mean over every rank's scenes is one step on the mean
        flat = mesh_sum(self.mesh, torch.cat(
            [n.reshape(-1) for n in new]
            + [torch.full((1,), float(len(scenes)), device=denom.device)]))
        with torch.no_grad():
            i = 0
            for b in stats:
                b.copy_(flat[i:i + b.numel()].view_as(b) / flat[-1])
                i += b.numel()
        return mesh_sum(self.mesh, wsum) / denom, mesh_sum(self.mesh, conf)


def make_stacked_segmentation_steps(model, optimizer, class_weights,
                                    num_classes, mesh=None, accumulate=1):
    """(train_step, eval_step) over stacked graphs already on the model's
    device, the counterpart of stinet_tpu/trainers/segmentation.py:
    make_stacked_segmentation_steps. With a data `mesh` each rank passes
    its slice of the global batch and every sum below runs over the ranks.

    train_step(graph, lr) -> ({"loss"}, confusion matrix): the scenes one
    by one, loss sum_b wsum_b / sum_b wnorm_b (wnorm, the class-weight
    total, does not depend on the parameters, so the gradient is
    sum_b grad(wsum_b) / sum_b wnorm_b, the concatenated batch's up to
    summation order); the confusion matrices summed. Batch norm follows
    JAX's rule: each scene is normalized with its own statistics, and the
    running statistics take one step per call, from the same incoming
    statistics, on the mean over every rank's scenes, so the result does
    not depend on how the scenes are split over ranks.
    eval_step(graph, w) -> ({"loss"}, [B, V_pad] predictions, confusion):
    w, one weight (1 or 0) a scene, takes the val loader's tail repeats
    out of the loss and the matrix."""
    def row_weights(graph):
        return cse_row_weights(graph.labels, class_weights, 0,
                               vertex_mask(graph))

    def scene_terms(graph):
        vmask = vertex_mask(graph)
        logits = model(graph)
        wsum, _ = cse_loss_terms(logits, graph.labels, weights=class_weights,
                                 ignore_index=0, valid_mask=vmask)
        return wsum, _confusion(graph, logits.detach(), vmask,
                                num_classes)[1]

    def eval_step(graph, w):
        model.eval()
        with full_f32_matmuls(), torch.no_grad():
            wsum = wnorm = 0.0
            conf = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                               device=graph.x.device)
            preds = []
            for i, wi in enumerate(w):
                g = scene_of(graph, i)
                vmask = vertex_mask(g)
                logits = model(g)
                ws, wn = cse_loss_terms(logits, g.labels,
                                        weights=class_weights,
                                        ignore_index=0, valid_mask=vmask)
                pred, c = _confusion(g, logits, vmask, num_classes)
                wsum, wnorm = wsum + ws * float(wi), wnorm + wn * float(wi)
                if wi:
                    conf = conf + c
                preds.append(pred)
            loss = (mesh_sum(mesh, wsum)
                    / torch.clamp(mesh_sum(mesh, wnorm), min=1e-8))
            return {"loss": loss}, torch.stack(preds), mesh_sum(mesh, conf)

    return (_StackedSegTrainStep(model, optimizer, scene_terms, accumulate,
                                 row_weights, num_classes, mesh), eval_step)


def _confusion(graph, logits, vmask, num_classes):
    """(predictions, confusion matrix) of one graph's logits over its
    valid vertices whose label is not 0."""
    pred = logits.argmax(-1)
    return pred, confusion_matrix_update(
        pred, graph.labels, num_classes,
        vmask * (graph.labels != 0).to(vmask.dtype))


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
        # the loader decides the layout, the trainer follows
        self._stacked = bool(getattr(self.data_loader, "stacked", False))
        self._mesh = maybe_data_mesh(config.config, self.device, logger)
        if self._stacked:
            self._train_step, self._eval_step = \
                make_stacked_segmentation_steps(
                    self.model, self.optimizer, self.class_weights,
                    self.num_classes, mesh=self._mesh,
                    accumulate=self.num_accum)
        elif self._mesh is not None:
            raise NotImplementedError(CONCATENATED_REFUSAL)
        else:
            self._train_step, self._eval_step = make_segmentation_steps(
                self.model, self.optimizer, self.class_weights,
                self.num_classes, accumulate=self.num_accum)

        if config.resume is not None:
            self._resume_checkpoint(config.resume)
        replicate_to_mesh(self._mesh, self.model, self.optimizer)

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

    def _stacked_val_weights(self):
        """This rank's scene weights of a stacked val batch: a val set
        smaller than the global test batch is padded by repeating scenes
        at the batch's tail (data/scannet.py:_SceneLoader), and the
        repeats weigh 0, so they bias neither the val loss, the IoU nor the
        monitor. All ones otherwise."""
        loader = self.data_loader.val_loader
        w = np.zeros(loader.batch_size, np.float32)
        w[:min(len(loader.dataset), loader.batch_size)] = 1.0
        local = loader.batch_size // multihost.process_count()
        rank = multihost.process_index()
        return w[rank * local:(rank + 1) * local]

    def _evaluate(self, graph):
        """({"loss"}, predictions, confusion) of one placed val batch."""
        if self._stacked:
            return self._eval_step(graph, self._stacked_val_weights())
        return self._eval_step(graph)

    def _valid_epoch(self, epoch):
        self.valid_metrics.reset()
        iou = IoU(self.num_classes, ignore_index=0)
        full_iou = IoU(self.num_classes, ignore_index=0)
        have_full = False
        for graph, names in iter_placed(self.data_loader.val_loader,
                                        self.device):
            metrics, pred, conf = self._evaluate(graph)
            iou.add_matrix(conf)
            for k, v in host_metrics(metrics).items():
                self.valid_metrics.update(k, v)
            if self._stacked:
                # a row a scene of this rank's, tail repeats dropped
                w = self._stacked_val_weights()
                rows = [(n, r) for n, r, wi in zip(
                    names, multihost.host_local_block(pred), w) if wi > 0]
            elif graph.num_graphs == 1:
                # only a one-scene batch's rows project onto one scene
                rows = [(names[0], pred.cpu().numpy())]
            else:
                rows = []
            for name, row in rows:
                have_full |= self._full_scene_add(full_iou, name, row)
        log = self.valid_metrics.result(write=True)
        per_class, miou = iou.value()
        log["mean_iou"] = float(miou)
        log["mean_precision"] = float(iou.precision()[1])
        log["overall_accuracy"] = iou.overall_accuracy()
        if multihost.process_count() > 1 and self._stacked:
            # each rank projected its own scenes: the matrices' sum is the
            # global one, and every rank runs this collective, whatever its
            # rows, so the key set stays the same on every rank
            conf = multihost.sum_array_across_hosts(
                full_iou.conf_metric.conf)
            if conf.sum() > 0:
                full_iou.conf_metric.reset()
                full_iou.add_matrix(conf)
                log["full_scene_mean_iou"] = float(full_iou.value()[1])
        elif have_full:
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
                _, pred, _ = self._evaluate(graph)
                # a stacked batch holds one scene a row
                rows = ([scene_of(graph, i) for i in range(len(names))]
                        if self._stacked else [graph])
                preds = pred if self._stacked else [pred]
                for name, g, p in zip(names, rows, preds):
                    n = int(g.levels[0].num_vertices)
                    vis.visualize_result(name, p[:n].cpu().numpy(),
                                         g.labels[:n].cpu().numpy())
        log = self._valid_epoch(0)
        for key, value in log.items():
            self.logger.info("    %-15s: %s", str(key), value)
