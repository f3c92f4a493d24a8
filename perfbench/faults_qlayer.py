"""Faults planted underneath the QKAN layer's training cell, to show that
its check catches them, as ``faults.py`` plants them in the other cells:
its CPU tests plant them at a small size, and ``readings_qlayer.py
--fault`` at the cell's own size on the card.

Each fault is ``install(patch)``, where ``patch(owner, name, value)``
sets an attribute.  The kinds: half of the batch left out (its rows
replaced by the other half's), stale weights (every second step takes
the weights the step before it took), an answer altered where it is
produced (one entry of K5's dW, as the trainer receives it).
"""

from __future__ import annotations

import torch


def _trainer():
    from qkan_implementation_tpu_torch.models.qkan_layer import (
        QKANLayerTrainer,
    )
    return QKANLayerTrainer


def _half_batch(patch):
    cls = _trainer()
    step = cls.step

    def half(self, x, y):
        h = x.shape[0] // 2
        return step(self, torch.cat([x[:h], x[:h], x[2 * h:]]),
                    torch.cat([y[:h], y[:h], y[2 * h:]]))

    patch(cls, "step", half)


def _dw_bumped(patch):
    cls = _trainer()
    unfold = cls.unfold

    def bumped(self, dw):
        delta = torch.zeros_like(dw)
        delta.view(-1)[0] = 0.5
        return unfold(self, dw + delta)

    patch(cls, "unfold", bumped)


def _stale_weights(patch):
    cls = _trainer()
    fold = cls.fold
    folds = []

    def stale(self, weights):
        folds.append(fold(self, weights))
        del folds[:-2]
        return folds[0]  # every second step: the fold of the step before

    patch(cls, "fold", stale)


# cell -> fault name -> install(patch)
FAULTS = {
    "qkan-layer-16x16-d7": {
        "half_batch": _half_batch,
        "stale_weights": _stale_weights,
        "answer_altered": _dw_bumped,
    },
}
