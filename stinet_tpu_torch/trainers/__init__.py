"""Training machinery of the port: optimizer, schedules, loss, steps, the
placement of batches, and the trainers (registered in core/registry.py's
TRAINERS by their config `type` names)."""
from stinet_tpu_torch.trainers.inpainting3d import (  # noqa: F401
    Inpainting3DTrainer)
from stinet_tpu_torch.trainers.segmentation import (  # noqa: F401
    GraphSegmentationTrainer)
