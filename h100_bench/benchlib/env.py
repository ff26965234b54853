"""The run's surroundings: build caches inside the checkout, the card, the
modules that must not be loaded, and what the result says of the device."""
import os
import subprocess
import sys
from pathlib import Path

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stinet_tpu")

CACHE_DIR = ".bench_cache"      # at the checkout's root; git-ignored


def prepare(root: Path) -> None:
    """Fixed cache directories inside the checkout for whatever builds
    kernels (the program builds its own into `stinet_tpu_torch/_build/`),
    and no JAX pulled in by a library."""
    cache = root / CACHE_DIR
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["STINET_DISABLE_GIT_TAG"] = "1"


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_problem(chips: int):
    """None when `chips` cards are visible, else why not."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, "
                f"{torch.cuda.device_count()} visible")
    return None


def power_limit_w():
    """The card's power limit in watts by nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(chips: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes),
            "power_limit_w": power_limit_w()}
