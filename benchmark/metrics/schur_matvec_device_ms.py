"""schur_matvec_device_ms: the device's ms of one reduced-camera-system
product as the CG runs it inside the replays: the median of the replayed
``schur_matvec`` device spans (stamps inside SchurFactors.schur_matvec,
fused and unfused) over the traced run's sub-window (progtrace.py);
schur_matvec_roofline times the same call alone, after the window.
Moves obs_per_s."""

import progtrace


def read(ctx):
    r = progtrace.reading(ctx)
    return None if r is None else r["schur_matvec_device_ms"]
