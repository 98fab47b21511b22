"""Profiling hook (counterpart of mmnas_tpu/utils/profiling.py).

`epoch_trace` wraps the first epoch of a run in `torch.profiler` and, when
the epoch ends, writes its trace (Chrome trace-event JSON, host ops and,
on a CUDA machine, the device's kernels) to
LOG_ROOT/profile_<VERSION>/trace.json; open it in Perfetto or
chrome://tracing. Enabled with --PROFILE.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def _trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def epoch_trace(cfg, epoch: int, start_epoch: int):
    if getattr(cfg, "PROFILE", False) and epoch == start_epoch:
        log_dir = os.path.join(cfg.LOG_ROOT, f"profile_{cfg.VERSION}")
        os.makedirs(log_dir, exist_ok=True)
        return _trace(log_dir)
    return contextlib.nullcontext()
