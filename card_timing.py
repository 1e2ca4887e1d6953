"""Timing on the card by CUDA events, and the tapes K2 is timed on.

Shared by `chip_smoke.py` and `time_run_ensemble.py`. Imports torch and
nothing of the port, so that `time_run_ensemble.py` can import another
checkout's port after it.
"""

import time

import torch


def cuda_ms(fn, reps, warmup=3, host=None):
    """Mean device milliseconds per call of ``fn`` by CUDA events. A
    sleep kernel holds the stream while the host queues the calls, so
    host-side launch cost does not show in the time; the host's own
    milliseconds per call (queueing only) go to ``host[0]`` when a list
    is given."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if host is not None:
        host[:] = [(time.perf_counter() - t0) * 1e3 / reps]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k2_tapes(ptape, dtape, gen):
    """The int32 tapes K2 is timed on, each of ``ptape``'s shape, as
    (name, tape, size_a, cl_k): the main path's final program and data
    tapes (``ptape``, ``dtape``; the data tape started all zero) at its
    cl_k=3; a tape uniform over 5 symbols (no skew) at cl_k 3 and 6
    (15,625 bins); a constant tape (every window in one bin); a tape
    uniform over 2 symbols at cl_k 14 (16,384 bins). New tapes are drawn
    from ``gen`` on ``ptape``'s card."""
    shape, dev = tuple(ptape.shape), ptape.device
    uniform5 = torch.randint(0, 5, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    uniform2 = torch.randint(0, 2, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    return [("ex5 program", ptape, 5, 3), ("ex5 data", dtape, 5, 3),
            ("uniform 5", uniform5, 5, 3),
            ("constant 0", torch.zeros_like(ptape), 5, 3),
            ("uniform 5, cl_k 6", uniform5, 5, 6),
            ("uniform 2, cl_k 14", uniform2, 2, 14)]
