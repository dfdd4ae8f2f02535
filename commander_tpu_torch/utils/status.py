"""Status/trace file and phase timers.

The port's copy of commander_tpu.utils.status (the reference's
comm_status_mod.f90 update_status :56-70: "elapsed, rank, RSS-GB, tag"
appended at every phase boundary, and the wall_time sections of
comm_system_backend.cpp:86-117).

Timer.stop synchronizes the card (when one is in use) before it reads the
clock, so a phase's seconds are the device's time for the phase and not the
time it took to queue its launches. It synchronizes once per phase stop,
never inside a step.
"""
from __future__ import annotations

import os
import time

import torch


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return float(line.split()[1]) / 1024**2
    except OSError:
        pass
    return 0.0


class StatusFile:
    """Append-only trace of tagged checkpoints with elapsed time and RSS."""

    def __init__(self, path: str | None, rank: int = 0):
        self.path = path
        self.rank = rank
        self.t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "a") as f:
                f.write(f"# status restarted at {time.ctime()}\n")

    def update(self, tag: str):
        line = (f"{time.time() - self.t0:12.3f} {self.rank:4d} "
                f"{_rss_gb():8.3f} GB  {tag}\n")
        if self.path:
            with open(self.path, "a") as f:
                f.write(line)
        return line


class Timer:
    """Named wall-time accumulators (the reference's wall_time sections).
    device: the torch device whose queue stop() waits for (a CUDA device
    synchronizes; None or the CPU does not)."""

    def __init__(self, device=None):
        self.acc: dict[str, float] = {}
        self._start: dict[str, float] = {}
        dev = None if device is None else torch.device(device)
        self._sync = dev is not None and dev.type == "cuda"

    def start(self, name: str):
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        if self._sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._start.pop(name)
        self.acc[name] = self.acc.get(name, 0.0) + dt
        return dt

    def report(self) -> str:
        return "\n".join(f"  {k:<28s} {v:10.3f} s"
                         for k, v in sorted(self.acc.items()))
