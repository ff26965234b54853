"""Device memory counters of the trainer (`stinet_tpu/utils/profiling.py`'s
`device_memory_stats`; the rest of that module is JAX tracing and timing,
which `utils/profile_forward.py` and `chip_smoke.py` do for the port)."""
import torch


def device_memory_stats(device: torch.device):
    """{"mem_allocated", "mem_reserved"}: bytes the caching allocator has
    handed out and holds on `device`; 0 on a CPU device."""
    if device.type != "cuda":
        return {"mem_allocated": 0, "mem_reserved": 0}
    return {"mem_allocated": torch.cuda.memory_allocated(device),
            "mem_reserved": torch.cuda.memory_reserved(device)}
