"""What decides `correct`. A traffic's check names a judge,
`<check>.py` (the sweep, the patch), which holds the timed path's products
to the plain reference for any model; the model's adapter to it,
`<reference>_<check>.py`, says what differs by model (its reference, how a
batch's frames, gt and loss are made). Each judge has `NAMES` (the
numbers compared), `kept_batches(run)`, `hooks(A, run, patches)` (what it
keeps of the timed path), `judge(A, run, device)` (each number beside its
limit) and `control(A, cell, seed, device, cast, n_batches, batch_size)`,
where A is the adapter."""
from __future__ import annotations

import numpy as np

# the judge reads SAMPLE_BATCHES of the window's first SAMPLE_WITHIN batches
SAMPLE_BATCHES, SAMPLE_WITHIN = 3, 10


def kept_batches(run, stream: int) -> list:
    """The indices of the batches that the judge reads, drawn from the
    seed (and the judge's `stream`) before the run."""
    rng = np.random.default_rng([run.seed, stream])
    pick = rng.choice(SAMPLE_WITHIN, SAMPLE_BATCHES, replace=False)
    return sorted(run.cell.traffic["warmup_batches"] + int(p) for p in pick)
