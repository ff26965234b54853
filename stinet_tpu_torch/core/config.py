"""JSON experiment config parser, with the config surface of the reference
and of `stinet_tpu/core/config.py`: the same JSON schema, the same CLI
flags (-c/-r/-d/-t/-n/-m/-g/-e/-v plus `;`-separated key-path overrides),
the same run-directory layout `saved/{models,log}/<name>/<MMDD_HHMMSS>_<id>/`
with the resolved config.json snapshot, and resume-mode config rediscovery
next to the checkpoint. Objects are built through typed registries
(core/registry.py).

`-d` maps onto torch: `cpu`, `cuda` or `cuda:N` is the trainer's device
(`ConfigParser.device`; None leaves the trainer's default, the card), and a
digit string such as `0` or `0,1` sets CUDA_VISIBLE_DEVICES, which takes
effect because nothing has touched CUDA yet when the flags are parsed.
"""
import json
import logging
import os
import subprocess
from datetime import datetime
from functools import reduce
from operator import getitem
from pathlib import Path

from stinet_tpu_torch.core.logging import setup_logging

LOG_LEVELS = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}


def read_json(path):
    with open(path) as f:
        return json.load(f)


def write_json(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, sort_keys=False)


def _set_by_path(tree, keys, value):
    keys = keys.split(";")
    reduce(getitem, keys[:-1], tree)[keys[-1]] = value


class ConfigParser:
    def __init__(self, config, resume=None, modification=None, run_id=None,
                 git_hash=None, dry_run=False, device=None):
        for k, v in (modification or {}).items():
            if v is not None:
                _set_by_path(config, k, v)
        self._config = config
        self.resume = resume
        self.dry_run = dry_run
        self.device = device

        save_root = Path(config.get("trainer", {}).get("save_dir", "saved"))
        exper_name = config.get("name", "experiment")
        timestamp = datetime.now().strftime(r"%m%d_%H%M%S")
        run_id = timestamp if run_id is None else f"{timestamp}_{run_id}"
        self._save_dir = save_root / "models" / exper_name / run_id
        self._log_dir = save_root / "log" / exper_name / run_id

        if not dry_run:
            # tag the current commit per run, as the reference does; a
            # missing or odd git state never blocks training
            if not os.environ.get("STINET_DISABLE_GIT_TAG"):
                try:
                    subprocess.run(
                        ["git", "tag", f"{exper_name}_{run_id}"],
                        capture_output=True, timeout=10, check=False)
                except (OSError, subprocess.SubprocessError):
                    pass
            self.save_dir.mkdir(parents=True, exist_ok=True)
            self.log_dir.mkdir(parents=True, exist_ok=True)
            write_json(self.config, self.save_dir / "config.json")
            write_json(self.config, self.log_dir / "config.json")
            setup_logging(self.log_dir)

    @classmethod
    def from_args(cls, args, options=(), argv=None):
        """A parser from an ArgumentParser (which parses `argv`, or
        sys.argv when None, after `options` are added to it) or from
        already parsed args (a namedtuple)."""
        for opt in options:
            args.add_argument(*opt.flags, default=None, type=opt.type)
        if not isinstance(args, tuple):
            args = args.parse_args(argv)

        device = None
        if getattr(args, "device", None) is not None:
            if args.device.isdigit() or "," in args.device:
                os.environ["CUDA_VISIBLE_DEVICES"] = args.device
            else:
                device = args.device
        if args.resume is not None:
            resume = Path(args.resume)
            cfg_fname = resume.parent / "config.json"
        else:
            if args.config is None:
                raise ValueError("Configuration file needs to be specified. "
                                 "Add '-c config.json', for example.")
            resume = None
            cfg_fname = Path(args.config)

        config = read_json(cfg_fname)
        if args.config and resume:
            config.update(read_json(args.config))  # fine-tune merge

        if getattr(args, "message", None):
            config["description"] = args.message
        config.setdefault("description", "")
        config["eval"] = getattr(args, "eval", None)
        config["vis"] = bool(getattr(args, "vis", False))
        git_hash = getattr(args, "git_hash", None)
        if git_hash is not None:
            config["git_hash"] = git_hash
        config.setdefault("git_hash", None)

        def opt_name(flags):
            for f in flags:
                if f.startswith("--"):
                    return f.replace("--", "")
            return flags[0].replace("--", "")

        modification = {opt.target: getattr(args, opt_name(opt.flags))
                        for opt in options}
        return cls(config, resume, modification,
                   run_id=getattr(args, "name", None), git_hash=git_hash,
                   dry_run=bool(getattr(args, "dry_run", False)),
                   device=device)

    # -- registry-backed factories ----------------------------------------
    def init_obj(self, name, registry, *args, **kwargs):
        spec = self[name]
        ctor = registry.get(spec["type"]) if hasattr(registry, "get") \
            else getattr(registry, spec["type"])
        module_args = dict(spec.get("args", {}))
        if any(k in module_args for k in kwargs):
            raise ValueError("Overwriting kwargs given in config file is "
                             "not allowed")
        module_args.update(kwargs)
        return ctor(*args, **module_args)

    def init_obj_with_config(self, name, registry, *args, **kwargs):
        spec = self[name]
        ctor = registry.get(spec["type"]) if hasattr(registry, "get") \
            else getattr(registry, spec["type"])
        return ctor(dict(spec.get("args", {})), *args, **kwargs)

    def __getitem__(self, name):
        return self._config[name]

    def __contains__(self, name):
        return name in self._config

    def get(self, name, default=None):
        return self._config.get(name, default)

    def get_logger(self, name, verbosity=2):
        logger = logging.getLogger(name)
        logger.setLevel(LOG_LEVELS[verbosity])
        return logger

    @property
    def config(self):
        return self._config

    @property
    def save_dir(self):
        return self._save_dir

    @property
    def log_dir(self):
        return self._log_dir
