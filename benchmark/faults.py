"""Faults planted in the timed path, underneath the harness, for reading
the limits' upper ends on the card (probe.py --fault) and for the tests
that see a broken run come out not correct:

- ``unchanged``: every GN step returns its state unchanged (and a zero
  correction, so the loop stops at once);
- ``half``: half of the observations left out: every other row of the
  port's stream weighs nothing;
- ``altered``: the answer altered where it is produced: one tie point's X
  moved half a metre in what the adjustment returns.

The cell has one card, so no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(name: str | None):
    """The port (benchmark/port.py's imports of it) with fault `name`
    planted for the block's span; None plants nothing."""
    import port

    if name is None:
        yield
        return
    if name not in NAMES:
        raise ValueError(f"no fault {name!r}; one of {NAMES}")
    saved = dict(schur_step_fn=port.schur_step_fn, drive=port.drive,
                 from_problem=port.ObsData.__dict__["from_problem"])
    if name == "unchanged":
        make = saved["schur_step_fn"]

        def frozen(*a, **kw):
            step = make(*a, **kw)

            def same(x, obs, tol, lam=0.0):
                _, _, v, stats, cg = step(x, obs, tol, lam)
                return x, torch.zeros((), dtype=x.dtype, device=x.device), v, stats, cg
            return same

        port.schur_step_fn = frozen
    elif name == "half":
        build = saved["from_problem"].__func__

        def half(*a, **kw):
            obs = build(*a, **kw)
            obs.W[1::2] = 0
            return obs

        port.ObsData.from_problem = staticmethod(half)
    else:
        drive = saved["drive"]

        def altered(*a, **kw):
            (x, *rest), cg = drive(*a, **kw)
            x = x.clone()
            x[-3] += 0.5
            return (x, *rest), cg

        port.drive = altered
    try:
        yield
    finally:
        port.schur_step_fn = saved["schur_step_fn"]
        port.drive = saved["drive"]
        port.ObsData.from_problem = saved["from_problem"]
