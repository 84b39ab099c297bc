"""Device times and the card's identity: CUDA events after a spin, and
nvidia-smi's name and power limit (a copy of the port's utils/cudatime
cuda_ms and card, kept with the benchmark)."""

from __future__ import annotations

import statistics
import subprocess

import torch

SPIN_CYCLES = 40_000_000  # ~20 ms of the card's clock


def cuda_ms(fn, reps=20, warmup=3):
    """Median device time of fn() in ms, from CUDA events around each of
    `reps` calls.  The card first spins for SPIN_CYCLES, so the host
    queues the calls (and their events) before the first one runs: the
    events then time the card's work, not the host's time to launch it,
    as far as the host keeps ahead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
