from fish_eye_bundle_adjustment_tpu_torch.io.readers import (  # noqa: F401
    discover_dataset,
    read_cnt,
    read_cze,
    read_ext,
    read_int,
    read_pho,
    read_tie,
)
from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem, build_problem  # noqa: F401
