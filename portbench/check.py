"""The comparison that decides ``correct``.

The window's answers are its steps: each turns the state it is given into
the next state (and, where the cell records one, a record of moments).  A
run keeps the first step, the last, and ``k`` more drawn from the seed
among the others (a reservoir sample, so every step of a window of any
length is as likely to be kept).  Once the window has closed, the plain
reference takes each kept step's input, steps it in float64, and two
numbers are compared with the cell's limits:

* ``step_err``: the worst over the kept steps of
  ``max|y - r| / max|r - x|``, the program's step ``x -> y`` against the
  reference's ``x -> r``, measured on the step's own change (a step that
  returns its input unchanged reads exactly 1);
* ``record_err``: the worst relative gap between what the program recorded
  after a kept step and the reference's record of the program's own state
  ``y`` (mass, energy, temperature, entropy, kinetic energy: against their
  own size; momentum: against ``sqrt(2 mass energy)``).

A non-finite step or record reads ``inf``.  The reference's tables are
built on the first comparison, after the window: none of their seconds is
set-up.  A cell whose state relaxes restarts it (``restart_every`` in its
traffic), so that the steps compared lie in the same stretch of the
solution however many steps a window holds: near equilibrium the step's
own change shrinks while rounding does not, and a faster program would
otherwise read a larger ``step_err``.
"""

from __future__ import annotations

import math
import random

import torch

from . import solvers


class Samples:
    """Steps kept for the comparison: ``(n, x, y, record)`` of step 0, of
    the last step and of ``k`` steps drawn from the seed in between."""

    def __init__(self, k: int, seed: int):
        self._rng = random.Random(seed)
        self._k = k
        self._seen = 0
        self.first = None
        self.last = None
        self.reservoir: list = []

    def offer(self, n: int, x, y, record) -> None:
        item = (n, x, y, record)
        if n == 0:
            self.first = item
            return
        if self.last is not None:  # the previous last step is one of those in between
            self._seen += 1
            if len(self.reservoir) < self._k:
                self.reservoir.append(self.last)
            else:
                j = self._rng.randrange(self._seen)
                if j < self._k:
                    self.reservoir[j] = self.last
        self.last = item

    def items(self) -> list:
        out = [s for s in [self.first, *self.reservoir, self.last] if s is not None]
        return sorted({s[0]: s for s in out}.values(), key=lambda s: s[0])


def _gap(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    if not bool(torch.isfinite(a).all()):
        return math.inf
    return float((a - b).abs().max() / scale.abs().max())


def record_gap(program: dict, reference: dict) -> float:
    """Worst relative gap between two records (dicts of tensors)."""
    worst = 0.0
    for name, ref in reference.items():
        if name == "momentum":
            scale = torch.sqrt(2.0 * (reference["mass"] * reference["energy"]).abs())
        else:
            scale = ref
        worst = max(worst, _gap(program[name], ref, scale))
    return worst


def compare(problem: solvers.Problem, items: list) -> dict:
    """``{name: value}`` of the compared numbers over the kept steps (whole
    states), the reference in ``problem``'s float64 tables."""
    step_err, record_err, has_record = 0.0, 0.0, False
    for _n, x, y, rec in items:
        if not bool(torch.isfinite(y).all()):
            step_err = math.inf
            continue
        r, _ = problem.reference_step(x)
        step_err = max(step_err, _gap(y, r, r - x.double()))
        prog = solvers.program_record(problem, rec)
        if prog is not None:
            has_record = True
            record_err = max(record_err, record_gap(prog, problem.reference_record(y)))
    out = {"step_err": step_err}
    if has_record:
        out["record_err"] = record_err
    return out
