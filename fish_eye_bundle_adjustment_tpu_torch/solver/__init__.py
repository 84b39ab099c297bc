from fish_eye_bundle_adjustment_tpu_torch.solver.dense import DenseResult  # noqa: F401
