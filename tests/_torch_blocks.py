"""Synthetic blocks shared by the PyTorch-port parity tests
(tests/test_torch_*.py): each is made once by the JAX package's
generator and handed to both packages as the same arrays."""

import dataclasses

SELFCAL = dict(
    estimate_c=True, estimate_xp=True, estimate_yp=True,
    estimate_radial=True, estimate_decent=True,
)

# name -> make_block keyword arguments (the sizes of tests/test_fusedmv.py)
BLOCKS = {
    "eop12": dict(n_img=12, n_pts=150, seed=13, control_frac=0.08,
                  settings_overrides={"inner_constraints": False}),
    "selfcal16": dict(n_img=16, n_pts=250, seed=11, control_frac=0.05,
                      settings_overrides={"inner_constraints": False, **SELFCAL}),
    "ic12": dict(n_img=12, n_pts=150, seed=5, control_frac=0.0,
                 settings_overrides={"inner_constraints": True}),
    # 4 of 6 EOPs and 2 IOPs: the operator's row offsets for ne < 6
    "partial12": dict(n_img=12, n_pts=150, seed=7, control_frac=0.08,
                      settings_overrides={"inner_constraints": False,
                                          "estimate_w": False, "estimate_p": False,
                                          "estimate_c": True, "estimate_xp": True}),
    # three cameras round-robin over the images, each self-calibrating:
    # per-camera IOP gathers and camera-axis segment sums
    "cam3_12": dict(n_img=12, n_pts=150, n_cams=3, seed=41, control_frac=0.08,
                    settings_overrides={"inner_constraints": False, **SELFCAL}),
}


def jax_block(name, **settings):
    """The JAX package's BAProblem for BLOCKS[name], fisheye model, with
    `settings` added to its settings overrides."""
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    kw = dict(BLOCKS[name])
    kw["settings_overrides"] = {**kw["settings_overrides"], **settings}
    return make_block(model="fisheye", **kw).problem


def to_port(problem):
    """The same problem as the port's BAProblem."""
    from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem

    return BAProblem.from_arrays(dataclasses.asdict(problem))
