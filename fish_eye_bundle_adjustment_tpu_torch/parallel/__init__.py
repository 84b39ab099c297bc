"""Scale-out solvers on torch.distributed (one rank per device), and the
pose-graph merge of blocks solved one a card."""

from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import (  # noqa: F401
    init_distributed,
    make_mesh,
    run_ranks,
)
from fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur import solve_schur_distributed  # noqa: F401
from fish_eye_bundle_adjustment_tpu_torch.parallel.sharded_state import solve_schur_sharded_state  # noqa: F401
from fish_eye_bundle_adjustment_tpu_torch.parallel.fusedshard import solve_schur_fused_sharded  # noqa: F401
from fish_eye_bundle_adjustment_tpu_torch.parallel.posegraph import solve_posegraph  # noqa: F401
