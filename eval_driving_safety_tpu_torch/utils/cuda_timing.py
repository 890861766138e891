"""The card's own time for a call, without the host's.

`device_ms(fn)` queues `reps` calls of `fn` behind a sleep kernel, so
that the card runs them back to back once the sleep ends, and reads the
time between an event recorded after the sleep and one after the last
call. The sleep is sized from the host time of one call; if it ended
before the host had queued every call (the card then idled between
calls), it is lengthened and the measurement repeated. `fn` must not
wait on the card.
"""
from __future__ import annotations

import time

import torch

_CYCLES_PER_S = 2.0e9          # about the SM clock of an H100; only sizes


def device_ms(fn, reps: int = 10, tries: int = 4) -> float:
    """Mean device time of one call of `fn` over `reps` calls, after two
    warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(_CYCLES_PER_S * max(3 * reps * host_s, 1e-3))
    for _ in range(tries):
        slept = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        slept.record()
        for _ in range(reps):
            fn()
        end.record()
        drained = slept.query()
        end.synchronize()
        if not drained:
            return slept.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the host could not queue the calls "
                       "ahead of the card")
