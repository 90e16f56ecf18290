"""Profiling and timing (PyTorch counterpart of
`historymatching_tpu.profiling`).

`trace` records a `torch.profiler` trace (the card's activity where there
is one, and the host's) and exports it as a Chrome trace; `parse_trace`
sums its device activities (kernels, copies, memsets) and host ops by
name; `timed` is a wall-clock timer that waits for the card.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from typing import NamedTuple

import torch

# Chrome-trace categories of device activity in torch.profiler's export.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir=None):
    """`with profiling.trace(logdir): run()` records `run` with
    torch.profiler, the card's activity included where CUDA is available,
    waits for the card, and writes a Chrome trace `trace_<ns>.json` under
    `logdir` (by default a directory under the temporary directory).
    Yields `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "hm-torch-trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


class TraceTotals(NamedTuple):
    """Totals of one trace, by activity name: device seconds and counts
    (kernels, copies, memsets), and host seconds of the ops."""

    device: dict
    device_count: dict
    host: dict


def parse_trace(logdir):
    """Sum the newest Chrome trace under `logdir` (written by `trace`, or
    any `*.json` / `*.json.gz` of torch.profiler's) by activity name.
    Device activities do not nest on one stream, so their sum is the
    card's busy time; host ops nest (an op's span holds its children's),
    so sum only named leaves of those."""
    paths = sorted((p for pat in ("*.json", "*.json.gz")
                    for p in glob.glob(os.path.join(logdir, "**", pat), recursive=True)),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json, *.json.gz) under {logdir}")
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        events = json.load(f)["traceEvents"]
    out = TraceTotals({}, {}, {})
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, dur = e.get("cat", ""), e.get("name", ""), e.get("dur", 0) / 1e6
        if cat in DEVICE_CATS:
            out.device[name] = out.device.get(name, 0.0) + dur
            out.device_count[name] = out.device_count.get(name, 0) + 1
        elif cat in HOST_CATS:
            out.host[name] = out.host.get(name, 0.0) + dur
    return out


def timed(fn, *args, repeats=3, **kwargs):
    """Time `fn(*args, **kwargs)`, waiting for the card after each call.
    Returns (best_seconds, first_call_seconds): the first call includes
    any build or warm-up, the best of `repeats` further calls is the
    steady state."""
    _sync()
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best, first
