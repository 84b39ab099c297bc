"""The port's CUDA kernels on the card (marked gpu; skipped without one).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fusedmv_cuda.py

(--noconftest: tests/conftest.py sets up JAX for the other test files.)
Whether there is a card is decided inside each test.

Tolerances: each kernel against its plain PyTorch version on the same
inputs at relative norm <= 1e-5 per output the solver reads -- both are
f32, only the summation order differs -- and bitwise-equal output on a
repeated launch (no float atomics).  A solve on the card against the same
solve on the CPU (plain versions): x within rtol=3e-5, atol=3e-4."""

import numpy as np
import pytest
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import fusedmv
from fish_eye_bundle_adjustment_tpu_torch.solver import schur
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

pytestmark = pytest.mark.gpu

SELFCAL = dict(
    estimate_c=True, estimate_xp=True, estimate_yp=True,
    estimate_radial=True, estimate_decent=True,
)
BLOCKS = {
    "eop12": dict(n_img=12, n_pts=150, seed=13, control_frac=0.08,
                  settings_overrides={"inner_constraints": False}),
    "selfcal16": dict(n_img=16, n_pts=250, seed=11, control_frac=0.05,
                      settings_overrides={"inner_constraints": False, **SELFCAL}),
    "partial12": dict(n_img=12, n_pts=150, seed=7, control_frac=0.08,
                      settings_overrides={"inner_constraints": False,
                                          "estimate_w": False, "estimate_p": False,
                                          "estimate_c": True, "estimate_xp": True}),
}
MODES = {
    "matvec": (True, False, False),
    "rhs_precond": (False, True, True),
    "backsub": (True, True, False),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _linearized(name, dev):
    p = make_block(model="fisheye", **BLOCKS[name]).problem
    layout = ParamLayout(p)
    opts = schur.SchurOptions(dtype=np.float32)
    plan = schur.make_band_plan(p, layout, opts)
    obs = schur.ObsData.from_problem(p, layout, plan, device=dev)
    x0 = torch.as_tensor(layout.initial().astype(np.float32), device=dev)
    kern = schur.SchurKernel(layout, opts)
    fac = kern.linearize(x0 * layout.scale_like(x0), obs,
                         lam=torch.zeros((), device=dev))
    return plan, fac, kern.ne, kern.ni


def _assert_close(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu().double(), w.cpu().double()
        assert float((g - w).norm()) <= 1e-5 * max(float(w.norm()), 1e-30)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_kernels_match_plain(name):
    dev = _card()
    plan, fac, ne, ni = _linearized(name, dev)
    band = fac.obs.band
    rng = np.random.default_rng(0)
    rnd = lambda *s: torch.as_tensor(
        rng.standard_normal(s).astype(np.float32), device=dev)
    inputs = dict(vpose=rnd(8, plan.n_img_pad), vi=rnd(128), a_rows=rnd(8, plan.n_pad))

    k1 = lambda: fusedmv.fused_hpp_pass(band, fac.acam_t, fac.apt_t, ne, ni)
    got, again = k1(), k1()
    _assert_close(got, fusedmv.fused_hpp_pass_ref(band, fac.acam_t, fac.apt_t, ne, ni))
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    for mode, (with_v, with_a, with_precond) in MODES.items():
        kw = dict(with_precond=with_precond)
        if with_v:
            kw.update(vpose=inputs["vpose"], vi=inputs["vi"])
        if with_a:
            kw["a_rows"] = inputs["a_rows"]
        args = (band, fac.acam_t, fac.apt_t, fac.hpi_t, ne, ni)
        got, again = fusedmv.fused_schur_apply(*args, **kw), fusedmv.fused_schur_apply(*args, **kw)
        _assert_close(got, fusedmv.fused_schur_apply_ref(*args, **kw))
        assert all(torch.equal(a, b) for a, b in zip(got, again)), mode


def test_wrappers_raise_on_inputs_the_kernel_does_not_take():
    dev = _card()
    plan, fac, ne, ni = _linearized("eop12", dev)
    band = fac.obs.band
    with pytest.raises(ValueError, match="dtype"):
        fusedmv.fused_hpp_pass(band, fac.acam_t.double(), fac.apt_t, ne, ni)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((fac.acam_t.shape[0], 2 * plan.n_pad), device=dev)
        fusedmv.fused_hpp_pass(band, wide[:, ::2], fac.apt_t, ne, ni)
    with pytest.raises(ValueError, match="shape"):
        fusedmv.fused_schur_apply(band, fac.acam_t, fac.apt_t, fac.hpi_t[:9], ne, ni,
                                  a_rows=torch.zeros((8, plan.n_pad), device=dev))


def test_solve_on_card_matches_cpu():
    dev = _card()
    p = make_block(model="fisheye", **BLOCKS["eop12"]).problem
    opts = schur.SchurOptions(dtype=np.float32)
    fusedmv.reset_counts()
    on_card = schur.solve_schur(p, opts, compute_covariance=False, device=dev)
    assert fusedmv.kernel_launches["fused_hpp_pass"] == len(on_card.cg_iterations)
    assert fusedmv.plain_calls == {"fused_hpp_pass": 0, "fused_schur_apply": 0}
    on_cpu = schur.solve_schur(p, opts, compute_covariance=False, device="cpu")
    assert on_card.iterations == on_cpu.iterations
    assert on_card.stopped_on == on_cpu.stopped_on
    np.testing.assert_allclose(on_card.x, on_cpu.x, rtol=3e-5, atol=3e-4)
    assert abs(on_card.sigma02 - on_cpu.sigma02) <= 1e-4 * on_cpu.sigma02
