"""Command-line entry of the port's trainers, with the flags of the root
`train.py` (-c/-r/-d/-t/-n/-m/-g/-e/-v, --lr/--bs/--ld):

    python -m stinet_tpu_torch.train -c config.json            # on the card
    python -m stinet_tpu_torch.train -c config.json -d cpu     # plain torch
    python -m stinet_tpu_torch.train -r <run>/model_best.ckpt -e valid

Without `-d` the trainer runs on the card, and without one it exits with
`serving.resolve_device`'s error; `-d cpu` runs the kernels' plain torch
versions on the CPU. `--bs` sets the train batch size
(`data_loader;args;train_batch_size`, the key the ScanNet loader reads).

Across cards, one process a card under torchrun:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m stinet_tpu_torch.train -c config.json

`main` sets up the process group first (parallel/multihost.py: NCCL on
cards, gloo on the CPU, each rank's card from LOCAL_RANK); in a plain run
that is nothing. The batches then take the stacked layout, `--bs` is the
global batch, and each rank trains on its slice of it.
"""
import argparse
import collections
import subprocess

import numpy as np
import torch

from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.core.registry import TRAINERS
from stinet_tpu_torch.parallel import multihost
import stinet_tpu_torch.trainers  # noqa: F401  (registers trainer types)

DEFAULT_SEED = 123

CustomArgs = collections.namedtuple("CustomArgs", "flags type target")
OPTIONS = [
    CustomArgs(["--lr", "--learning_rate"], type=float,
               target="optimizer;args;lr"),
    CustomArgs(["--bs", "--batch_size"], type=int,
               target="data_loader;args;train_batch_size"),
    CustomArgs(["--ld", "--log_dir"], type=str, target="trainer;save_dir"),
]


def parser():
    args = argparse.ArgumentParser(description="stinet_tpu_torch")
    args.add_argument("-c", "--config", default=None, type=str,
                      help="config file path (default: None)")
    args.add_argument("-r", "--resume", default=None, type=str,
                      help="path to latest checkpoint (default: None)")
    args.add_argument("-d", "--device", default=None, type=str,
                      help="cpu, cuda or cuda:N; digits set "
                      "CUDA_VISIBLE_DEVICES (default: the card)")
    args.add_argument("-t", "--dry_run", default=False, type=bool,
                      help="disable logging of models to disk")
    args.add_argument("-n", "--name", default=None, type=str,
                      help="name of this training session")
    args.add_argument("-m", "--message", default=None, type=str,
                      help="description of this training session")
    args.add_argument("-g", "--git_hash", default=None, type=str,
                      help="manually enter git hash")
    args.add_argument("-e", "--eval", default=None, type=str,
                      help='evaluate on the "train", "valid" or "test" sets')
    args.add_argument("-v", "--vis", default=False, action="store_true",
                      help="visualize evaluation")
    args.add_argument("--deterministic", default=False, action="store_true",
                      help="torch's deterministic algorithms (warnings for "
                      "ops without one), so that two runs give the same "
                      "bits on a card")
    return args


def run(config):
    """Build the config's trainer and train it, or evaluate it with -e.
    Returns the trainer."""
    logger = config.get_logger("train")

    seed = config.get("seed") if config.get("seed") is not None \
        else DEFAULT_SEED
    logger.info("Random seed: %s", seed)
    logger.info("Processes: %s", multihost.describe())

    git_hash = config.get("git_hash")
    if git_hash is None:
        try:
            git_hash = subprocess.check_output(
                ["git", "describe", "--always"],
                stderr=subprocess.DEVNULL).strip().decode()
        except (OSError, subprocess.SubprocessError):
            git_hash = "unknown"
    logger.info("Git hash: %s", git_hash)
    logger.info("Description: %s", config.get("description", ""))

    np.random.seed(seed)

    trainer = TRAINERS.get(config["trainer"]["type"])(config)
    if config["eval"]:
        trainer.eval(config["eval"])
    else:
        trainer.train()
    return trainer


def main(argv=None):
    """Set up the process group under torchrun (nothing otherwise), parse
    `argv` (sys.argv when None) and run; returns the trainer."""
    multihost.initialize()
    if parser().parse_known_args(argv)[0].deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    return run(ConfigParser.from_args(parser(), OPTIONS, argv))


if __name__ == "__main__":
    main()
