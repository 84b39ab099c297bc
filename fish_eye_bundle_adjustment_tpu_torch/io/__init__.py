from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem, build_problem  # noqa: F401
