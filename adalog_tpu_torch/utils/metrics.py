"""Evaluation loop and metrics, the counterpart of ``adalog_tpu.utils.metrics``.

Parity: reference utils/test_utils.py — validate() computing top-1/top-5/loss
with running averages. The per-batch metrics are computed on the logits'
device; the host reads one transfer of the three sums a batch.
"""

from __future__ import annotations

import logging
import time

import torch

log = logging.getLogger("adalog_tpu_torch")


class AverageMeter:
    def __init__(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def batch_metrics(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(sum cross-entropy, #top-1 correct, #top-5 correct) as one float64
    tensor on the logits' device.

    Ties rank toward the lower class index, as ``jax.lax.top_k`` (a stable
    descending sort's first k) breaks them: a label is in the top k when
    fewer than k classes score above it or score equal with a lower index.
    A label past the last class gives a NaN loss and no hit, as JAX's
    out-of-bounds ``take_along_axis`` (NaN fill) does."""
    logits = logits.float()
    labels = labels.to(device=logits.device, dtype=torch.long)
    n_cls = logits.shape[-1]
    valid = labels < n_cls
    idx = torch.where(valid, labels, torch.zeros_like(labels))[:, None]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, idx)[:, 0]
    nll = torch.where(valid, nll, torch.full_like(nll, float("nan"))).sum()
    own = logits.gather(-1, idx)
    cls = torch.arange(n_cls, device=logits.device)
    rank = (logits > own).sum(-1) + \
        ((logits == own) & (cls[None, :] < idx)).sum(-1)
    correct1 = (valid & (rank < 1)).sum()
    correct5 = (valid & (rank < 5)).sum()
    return torch.stack([nll.double(), correct1.double(), correct5.double()])


def validate(loader, forward_fn, print_freq: int = 10):
    """forward_fn: images -> logits. loader yields (images, labels).

    Returns (loss, top1%, top5%) like test_utils.py:10-54, with the JAX
    package's log lines, and one more at the end: the images a second of
    the whole loop and the share of its wall time spent waiting for the
    loader."""
    loss_m, top1_m, top5_m, time_m = (AverageMeter() for _ in range(4))
    t_start = end = time.time()
    waited, images_seen = 0.0, 0
    it = iter(loader)
    i = 0
    while True:
        t_wait = time.time()
        try:
            images, labels = next(it)
        except StopIteration:
            break
        waited += time.time() - t_wait
        logits = forward_fn(images)
        nll, c1, c5 = batch_metrics(logits, torch.as_tensor(labels)).tolist()
        n = images.shape[0]
        images_seen += n
        loss_m.update(nll / n, n)
        top1_m.update(c1 * 100.0 / n, n)
        top5_m.update(c5 * 100.0 / n, n)
        time_m.update(time.time() - end)
        end = time.time()
        if i % print_freq == 0:
            log.info("Test: [%d] Time %.3f (%.3f) Loss %.4f (%.4f) "
                     "Prec@1 %.3f (%.3f) Prec@5 %.3f (%.3f)",
                     i, time_m.val, time_m.avg, loss_m.val, loss_m.avg,
                     top1_m.val, top1_m.avg, top5_m.val, top5_m.avg)
        i += 1
    wall = time.time() - t_start
    log.info(" * Prec@1 %.3f Prec@5 %.3f Loss %.3f Time %.3f",
             top1_m.avg, top5_m.avg, loss_m.avg, wall)
    log.info(" * %d images in %.3f s: %.1f img/s; waited %.3f s (%.1f%%) "
             "for the loader", images_seen, wall,
             images_seen / max(wall, 1e-9), waited,
             100.0 * waited / max(wall, 1e-9))
    return loss_m.avg, top1_m.avg, top5_m.avg
