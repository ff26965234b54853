"""TensorBoard writer with mode-suffixed tags and step tracking, as the
reference's TensorboardWriter: tags become `<tag>/<mode>`, and `set_step`
switches (step, mode) and writes a steps_per_sec scalar when a batch step
changes. Without tensorboard it does nothing. A copy of
`stinet_tpu/core/writer.py`."""
import importlib
import time


class TensorboardWriter:
    _TB_FNS = ("add_scalar", "add_scalars", "add_image", "add_images",
               "add_figure", "add_audio", "add_text", "add_histogram",
               "add_pr_curve", "add_embedding")

    def __init__(self, log_dir, logger=None, enabled=True):
        self.writer = None
        self.selected_module = ""
        if enabled:
            for module in ("torch.utils.tensorboard", "tensorboardX"):
                try:
                    self.writer = importlib.import_module(
                        module).SummaryWriter(str(log_dir))
                    self.selected_module = module
                    break
                except ImportError:
                    continue
            if self.writer is None and logger is not None:
                logger.warning(
                    "TensorBoard is configured but neither "
                    "torch.utils.tensorboard nor tensorboardX is installed; "
                    "logging to TB is disabled.")
        self.step = 0
        self.mode = ""
        self._timer = time.time()

    def set_step(self, step, mode="train", quiet=False):
        self.mode = mode
        self.step = step
        if step == 0:
            self._timer = time.time()
        elif not quiet:
            duration = time.time() - self._timer
            if duration > 0:
                self.add_scalar("steps_per_sec", 1.0 / duration)
            self._timer = time.time()

    def __getattr__(self, name):
        if name in self._TB_FNS:
            fn = getattr(self.writer, name, None)

            def wrapper(tag, data, *args, **kwargs):
                if fn is not None:
                    fn(f"{tag}/{self.mode}" if self.mode else tag, data,
                       self.step, *args, **kwargs)
            return wrapper
        raise AttributeError(name)
