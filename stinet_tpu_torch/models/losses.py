"""Loss functions, the counterpart of `stinet_tpu/models/losses.py` (the
reference's cse_loss, total_variation_loss and dice_loss, plus the
weighted cross entropy of the segmentation trainer). Images are NHWC, as
in the JAX package; the reference's are NCHW, and the formulas are
normalized the same way."""
import torch
import torch.nn.functional as F


def cse_loss_terms(logits, targets, weights=None, ignore_index=None,
                   valid_mask=None):
    """Weighted cross entropy's numerator and denominator (wsum, wnorm),
    so that loss = wsum / max(wnorm, eps). logits [N, C], targets [N] int;
    `weights` [C] per class, indexed with clip semantics (a target past
    the last class takes the last weight); rows whose target is
    `ignore_index`, or where `valid_mask` is 0, weigh 0. wnorm does not
    depend on the logits, so per-batch terms combine exactly: sum both,
    divide once."""
    targets = targets.to(torch.int64)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, targets[:, None])[:, 0]
    w = torch.ones_like(nll)
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=nll.dtype,
                                  device=nll.device)
        w = w * weights[targets.clamp(0, weights.shape[0] - 1)]
    if ignore_index is not None:
        w = w * (targets != ignore_index).to(w.dtype)
    if valid_mask is not None:
        w = w * valid_mask.to(w.dtype)
    return (nll * w).sum(), w.sum()


def cse_loss(logits, targets, weights=None, ignore_index=None,
             valid_mask=None):
    """CrossEntropyLoss with torch's semantics for class weights and
    ignore_index: sum(w_t * nll) / sum(w_t) over the rows that count."""
    wsum, wnorm = cse_loss_terms(logits, targets, weights, ignore_index,
                                 valid_mask)
    return wsum / torch.clamp(wnorm, min=1e-8)


def total_variation_loss(img, weight):
    """Squared-difference total variation of img [B, H, W, C] (NHWC, the
    JAX package's layout), normalized by its element count (reference
    losses.py:11-15)."""
    b, h, w, c = img.shape
    tv_h = ((img[:, 1:, :, :] - img[:, :-1, :, :]) ** 2).sum()
    tv_w = ((img[:, :, 1:, :] - img[:, :, :-1, :]) ** 2).sum()
    return weight * (tv_h + tv_w) / (b * h * w * c)


def dice_loss(logits, true, eps=1e-7):
    """Multiclass Sørensen–Dice loss; logits [N, C] (or [B, H, W, C]) and
    int labels of the same leading shape."""
    num_classes = logits.shape[-1]
    flat_logits = logits.reshape(-1, num_classes)
    one_hot = F.one_hot(true.reshape(-1).to(torch.int64),
                        num_classes).to(flat_logits.dtype)
    probas = F.softmax(flat_logits, dim=-1)
    intersection = (probas * one_hot).sum(0)
    cardinality = (probas + one_hot).sum(0)
    return 1.0 - (2.0 * intersection / (cardinality + eps)).mean()
