"""Classification metrics, the counterpart of
`stinet_tpu/metrics/metric.py` (the reference's accuracy and top-k
accuracy), with optional valid masks."""
import torch


def _masked_mean(correct, valid_mask):
    if valid_mask is None:
        return correct.mean()
    valid_mask = valid_mask.to(correct.dtype)
    return (correct * valid_mask).sum() / torch.clamp(valid_mask.sum(),
                                                      min=1.0)


def accuracy(logits, target, valid_mask=None):
    correct = (logits.argmax(-1) == target).to(torch.float32)
    return _masked_mean(correct, valid_mask)


def top_k_acc(logits, target, k=3, valid_mask=None):
    """Whether the target is among the k largest logits; ties rank as a
    stable ascending sort ranks them, as in the JAX package."""
    topk = torch.argsort(logits, dim=-1, stable=True)[..., -k:]
    correct = (topk == target[..., None]).any(-1).to(torch.float32)
    return _masked_mean(correct, valid_mask)
