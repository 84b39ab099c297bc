from fish_eye_bundle_adjustment_tpu_torch.models.projection import (  # noqa: F401
    MODEL_IDS,
    obs_jacobian_blocks,
    project_obs,
    residual_obs,
    rotation_matrix,
)
