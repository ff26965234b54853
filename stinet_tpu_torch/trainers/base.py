"""BaseTrainer: the epoch loop with wall-clock timing, metric-monitored
best tracking, early stopping and periodic checkpoints. The counterpart of
`stinet_tpu/trainers/base.py` (monitor strings like "min val_loss",
save_period, early_stop, dry_run).

In a `torch.distributed` group of more than one rank (parallel/
multihost.py) every rank trains on its share of each batch and runs this
loop: the epoch log is averaged across ranks (`mean_scalar_metrics`), so
the monitor's decisions agree; only rank 0 writes TensorBoard logs and
checkpoints, and every rank waits at the save points (`sync_hosts`). In
one process all of that is the identity. `SingleModelTrainer` adds the
checkpoints of a trainer of one model."""
import time
from abc import abstractmethod

import numpy as np

from stinet_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from stinet_tpu_torch.core.writer import TensorboardWriter
from stinet_tpu_torch.parallel import multihost


class BaseTrainer:
    def __init__(self, config):
        self.config = config
        self.logger = config.get_logger(
            "trainer", config["trainer"].get("verbosity", 2))

        cfg = config["trainer"]
        self.epochs = cfg["epochs"]
        self.save_period = cfg.get("save_period", 1)
        self.monitor = cfg.get("monitor", "off")

        if self.monitor == "off":
            self.mnt_mode, self.mnt_best = "off", 0
            self.early_stop = np.inf
        else:
            self.mnt_mode, self.mnt_metric = self.monitor.split()
            if self.mnt_mode not in ("min", "max"):
                raise ValueError(f"monitor {self.monitor!r}: the mode is "
                                 "min or max")
            self.mnt_best = np.inf if self.mnt_mode == "min" else -np.inf
            self.early_stop = cfg.get("early_stop", np.inf)

        self.start_epoch = 1
        self.checkpoint_dir = config.save_dir
        self.writer = TensorboardWriter(
            config.log_dir, self.logger,
            cfg.get("tensorboard", False) and not config.dry_run
            and multihost.is_primary())

    @abstractmethod
    def _train_epoch(self, epoch):
        raise NotImplementedError

    @abstractmethod
    def _eval(self, mode):
        raise NotImplementedError

    def train(self):
        not_improved_count = 0
        for epoch in range(self.start_epoch, self.epochs + 1):
            t0 = time.perf_counter()
            result = self._train_epoch(epoch)
            log = {"epoch": epoch, "time elapsed": time.perf_counter() - t0}
            log.update(result)
            # each rank trained on its share: average the floats, so the
            # decisions below agree on every rank
            log = multihost.mean_scalar_metrics(log)

            for key, value in log.items():
                self.logger.info("    {:15s}: {}".format(str(key), value))

            self._observe_lr(log)

            best = False
            if self.mnt_mode != "off":
                if self.mnt_metric not in log:
                    self.logger.warning(
                        "Warning: Metric '%s' is not found. Model "
                        "performance monitoring is disabled.",
                        self.mnt_metric)
                    self.mnt_mode = "off"
                else:
                    improved = (
                        (self.mnt_mode == "min"
                         and log[self.mnt_metric] <= self.mnt_best)
                        or (self.mnt_mode == "max"
                            and log[self.mnt_metric] >= self.mnt_best))
                    if improved:
                        self.mnt_best = log[self.mnt_metric]
                        not_improved_count = 0
                        best = True
                    else:
                        not_improved_count += 1
                    if not_improved_count > self.early_stop:
                        self.logger.info(
                            "Validation performance didn't improve for %s "
                            "epochs. Training stops.", self.early_stop)
                        break

            if not self.config.dry_run:
                # rank 0 writes; every rank waits at the same points
                if epoch % self.save_period == 0:
                    if multihost.is_primary():
                        self._save_checkpoint(epoch)
                    multihost.sync_hosts("save_checkpoint")
                if best:
                    if multihost.is_primary():
                        self._save_best(epoch)
                    multihost.sync_hosts("save_best")

    def _observe_lr(self, log):
        """Feed the monitored metric to stateful LR schedulers
        (ReduceLROnPlateau: torch's scheduler.step(metric) once per
        epoch). Stateless schedulers' observe() does nothing."""
        fn = getattr(self, "lr_fn", None)
        if fn is None or not hasattr(fn, "observe"):
            return
        key = getattr(self, "mnt_metric", None)
        for k in (key, "val_loss", "loss"):
            if k is not None and k in log:
                fn.observe(log[k])
                return

    def eval(self, mode):
        if self.config.resume is None:
            raise ValueError("Cannot evaluate a model without loaded "
                             "weights: pass -r <checkpoint>")
        self._eval(mode)

    def _progress(self, batch_idx, len_epoch):
        return "[{}/{} ({:.0f}%)]".format(
            batch_idx, len_epoch, 100.0 * batch_idx / max(len_epoch, 1))


class SingleModelTrainer(BaseTrainer):
    """A trainer of one model, `self.model`, with `self.optimizer` and a
    `graph_common._TrainStep` in `self._train_step`. Its checkpoints hold,
    under MODEL_KEY, the model's state dict and the optimizer's state, and
    the accumulation state in `extra` (with an empty `batch_stats`, the
    JAX package's layout; the running statistics are the state dict's
    buffers). A resume restores all three. A trainer with more models
    (a GAN's discriminator) names them in `_checkpointed`; a resume loads
    each that the file holds."""
    MODEL_KEY = "model"

    def _checkpointed(self):
        """{checkpoint key: (model, its optimizer)}."""
        return {self.MODEL_KEY: (self.model, self.optimizer)}

    def _state_save(self, epoch, path):
        parts = self._checkpointed()
        save_checkpoint(
            path,
            models={k: m.state_dict() for k, (m, _) in parts.items()},
            opt_states={k: o.state_dict() for k, (_, o) in parts.items()},
            epoch=epoch, monitor_best=self.mnt_best,
            config=self.config.config,
            archs={k: type(m).__name__ for k, (m, _) in parts.items()},
            extra={"batch_stats": {},
                   "accumulation": self._train_step.state()})

    def _save_checkpoint(self, epoch):
        path = str(self.checkpoint_dir / f"checkpoint-epoch{epoch}.ckpt")
        self._state_save(epoch, path)
        self.logger.info("Saving checkpoint: %s ...", path)

    def _save_best(self, epoch):
        path = str(self.checkpoint_dir / "model_best.ckpt")
        self._state_save(epoch, path)
        self.logger.info("Saving current best: model_best.ckpt ...")

    def _resume_checkpoint(self, resume_path):
        self.logger.info("Loading checkpoint: %s ...", resume_path)
        models, opts, extra, meta = load_checkpoint(resume_path)
        for k, (model, optimizer) in self._checkpointed().items():
            if k in models or k == self.MODEL_KEY:
                model.load_state_dict(models[k])
                optimizer.load_state_dict(opts[k])
        if "accumulation" in extra:
            self._train_step.load_state(extra["accumulation"])
        self.start_epoch = meta["epoch"] + 1
        self.mnt_best = meta["monitor_best"]
        self.logger.info(
            "Checkpoint loaded. Resume training from epoch %s",
            self.start_epoch)
