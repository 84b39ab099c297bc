"""PyTorch/CUDA port of the fish-eye bundle adjustment framework.

The JAX package ``fish_eye_bundle_adjustment_tpu`` is the reference; this
package mirrors its module names so each counterpart is found by path.
It imports ``torch`` and never ``jax``.  There is no global dtype switch:
every solver takes its dtype explicitly (``SchurOptions.dtype`` maps to a
torch dtype) and the conditioning scale of ``ParamLayout`` stays float64
on the host.  The two fused Schur kernels run as CUDA C++ on the card
(ops/csrc/fusedmv.cu) and as their plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"

from fish_eye_bundle_adjustment_tpu_torch.config import Settings  # noqa: E402,F401
from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem, build_problem  # noqa: E402,F401
