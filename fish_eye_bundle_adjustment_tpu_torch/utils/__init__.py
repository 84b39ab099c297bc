from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout  # noqa: F401
