"""Logging setup: DEBUG to the console and INFO to a rotating per-run
info.log, as the reference's dictConfig sets them. A copy of
`stinet_tpu/core/logging.py`."""
import logging
import logging.config
from pathlib import Path

_FMT_CONSOLE = "%(message)s"
_FMT_FILE = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def setup_logging(log_dir, default_level=logging.INFO):
    log_dir = Path(log_dir)
    config = {
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "simple": {"format": _FMT_CONSOLE},
            "datetime": {"format": _FMT_FILE},
        },
        "handlers": {
            "console": {
                "class": "logging.StreamHandler",
                "level": "DEBUG",
                "formatter": "simple",
                "stream": "ext://sys.stdout",
            },
            "info_file_handler": {
                "class": "logging.handlers.RotatingFileHandler",
                "level": "INFO",
                "formatter": "datetime",
                "filename": str(log_dir / "info.log"),
                "maxBytes": 10485760,
                "backupCount": 20,
                "encoding": "utf8",
            },
        },
        "root": {
            "level": "INFO",
            "handlers": ["console", "info_file_handler"],
        },
    }
    logging.config.dictConfig(config)
