from fish_eye_bundle_adjustment_tpu_torch.report.writers import write_reports  # noqa: F401
