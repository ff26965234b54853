"""Small utilities, a copy of `stinet_tpu/utils/misc.py` (the reference's
utils/util.py helpers): read_json / write_json, inf_loop,
pretty_print_arguments and clear_folder."""
import json
import os
import shutil
from itertools import repeat


def read_json(path):
    with open(path) as f:
        return json.load(f)


def write_json(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, sort_keys=False)


def inf_loop(data_loader):
    """Endlessly repeat a data loader (reference util.py:22-27)."""
    for loader in repeat(data_loader):
        yield from loader


def pretty_print_arguments(args):
    """Aligned key/value dump of an argparse Namespace (or a dict)."""
    d = vars(args) if not isinstance(args, dict) else args
    width = max((len(k) for k in d), default=0)
    return "\n".join(f"{k:<{width}} : {v}" for k, v in sorted(d.items()))


def clear_folder(path):
    """Delete and recreate a directory (reference utils/clear_folder.py)."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
