"""Faults planted in the program underneath a run, to show that a cell's
check catches them: its CPU tests plant them at a small size, and
``readings.py --fault`` at the cell's own size on the card.

Each fault is ``install(patch)``, where ``patch(owner, name, value)``
sets an attribute (``setattr``, or pytest's ``monkeypatch.setattr``).
The kinds: a step that returns its state unchanged; half of the batch
left out (its rows replaced by the other half's); an answer altered where
it is produced.
"""

from __future__ import annotations

import numpy as np
import torch


def _fixed_kan():
    from qkan_implementation_tpu_torch.models import fixed_kan
    return fixed_kan


def _degree_optimizer():
    from qkan_implementation_tpu_torch.optim import degree_optimizer
    return degree_optimizer


def _half_rows(out):
    h = out.shape[0] // 2
    return torch.cat([out[:h], out[:h], out[2 * h:]]) if h else out


def _bump(out):
    delta = torch.zeros_like(out)
    delta.view(-1)[0] = 0.5
    return out + delta


def _wrap_forward(patch, change):
    fk = _fixed_kan()
    apply = fk.kan_apply
    patch(fk, "kan_apply", lambda *a, **k: change(apply(*a, **k)))


def _unchanged_step(patch):
    from qkan_implementation_tpu_torch.models._optim import AdamGroup

    def step(self, grads):
        self.count += 1  # the count moves; parameters and moments do not

    patch(AdamGroup, "step", step)


def _wrap_sweep(patch, change):
    cls = _fixed_kan().FixedKAN
    sweep = cls._evaluate_layer_degrees
    patch(cls, "_evaluate_layer_degrees",
          lambda self, x, y: change(sweep, self, x, y))


def _sweep_half(sweep, self, x, y):
    h = x.shape[0] // 2
    return sweep(self, x[:h], y[:h])


def _sweep_bumped(sweep, self, x, y):
    scores, coeffs = sweep(self, x, y)
    return scores, [c * 1.01 for c in coeffs]


def _degree_altered(patch, module):
    solve = module.solve_qubo

    def wrong(model, **k):
        sample, energy = solve(model, **k)
        sample = sample.copy()
        dp1 = k["one_hot_block_size"]
        d = int(np.argmax(sample[:dp1]))
        sample[:dp1] = 0.0
        sample[(d + 1) % dp1] = 1.0
        return sample, energy

    patch(module, "solve_qubo", wrong)


def _fit_half(patch):
    cls = _degree_optimizer().DegreeOptimizer
    fit = cls.fit

    def half(self, x, y, weights=None, **k):
        h = len(x) // 2
        return fit(self, x[:h], y[:h], weights=weights[:h], **k)

    patch(cls, "fit", half)


def _market_predict_bumped(patch):
    cls = _degree_optimizer().DegreeOptimizer
    predict = cls.predict

    def bumped(self, x):
        out = predict(self, x).copy()
        out.reshape(-1)[0] += 1e-3
        return out

    patch(cls, "predict", bumped)


# cell -> fault name -> install(patch)
FAULTS = {
    "digits-train": {
        "state_unchanged": _unchanged_step,
        "half_batch": lambda p: _wrap_forward(p, _half_rows),
        "answer_altered": lambda p: _wrap_forward(p, _bump),
    },
    "digits-search": {
        "half_batch": lambda p: _wrap_sweep(p, _sweep_half),
        "answer_altered": lambda p: _wrap_sweep(p, _sweep_bumped),
        "degree_altered": lambda p: _degree_altered(p, _fixed_kan()),
    },
    "market-search": {
        "half_batch": _fit_half,
        "answer_altered": _market_predict_bumped,
        "degree_altered": lambda p: _degree_altered(p, _degree_optimizer()),
    },
}
