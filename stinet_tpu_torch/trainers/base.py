"""BaseTrainer: the epoch loop with wall-clock timing, metric-monitored
best tracking, early stopping and periodic checkpoints. The counterpart of
`stinet_tpu/trainers/base.py` (monitor strings like "min val_loss",
save_period, early_stop, dry_run), for one process: the JAX package's
multi-host averaging and barriers have nothing to do here."""
import time
from abc import abstractmethod

import numpy as np

from stinet_tpu_torch.core.writer import TensorboardWriter


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
            cfg.get("tensorboard", False) and not config.dry_run)

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
                if epoch % self.save_period == 0:
                    self._save_checkpoint(epoch)
                if best:
                    self._save_best(epoch)

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
