"""The port's CUDA kernels on the card (marked gpu; skipped without one).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fusedmv_cuda.py

(--noconftest: tests/conftest.py sets up JAX for the other test files.)
Whether there is a card is decided inside each test.

Tolerances: each kernel against its plain PyTorch version on the same
inputs at relative norm <= 1e-5 per output, at both operand precisions --
both round the same f32 values (computed alike, without fused
multiply-adds) to bf16 or bf16 hi + lo, so only the summation order of
the outputs differs -- and bitwise-equal output on a repeated launch
(no float atomics).  The reduce kernel alone is bitwise equal to the same sums taken
in its order on the host.  A solve on the card against the same solve on
the CPU (plain versions): x within rtol=3e-5, atol=3e-4."""

import numpy as np
import pytest
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import fusedmv
from fish_eye_bundle_adjustment_tpu_torch.solver import schur
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

from _torch_blocks import CAPS, STRESS, stress_plan, stress_streams

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
    # many groups, several 128-image blocks of the band reduce
    "img200": dict(n_img=200, n_pts=4000, seed=17, control_frac=0.02,
                   settings_overrides={"inner_constraints": False, **SELFCAL}),
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


def _check_all(band, acam_t, apt_t, hpi_t, ne, ni, inputs, precision="bf16x2"):
    """K1 and every K2 mode against the plain versions (every output in
    full) and bitwise against a second launch."""
    k1 = lambda: fusedmv.fused_hpp_pass(band, acam_t, apt_t, ne, ni, precision=precision)
    got, again = k1(), k1()
    _assert_close(got, fusedmv.fused_hpp_pass_ref(band, acam_t, apt_t, ne, ni, precision))
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "K1"

    for mode, (with_v, with_a, with_precond) in MODES.items():
        kw = dict(with_precond=with_precond, precision=precision)
        if with_v:
            kw.update(vpose=inputs["vpose"], vi=inputs["vi"])
        if with_a:
            kw["a_rows"] = inputs["a_rows"]
        args = (band, acam_t, apt_t, hpi_t, ne, ni)
        k2 = lambda: fusedmv.fused_schur_apply(*args, **kw)
        got, again = k2(), k2()
        _assert_close(got, fusedmv.fused_schur_apply_ref(*args, **kw))
        assert all(torch.equal(a, b) for a, b in zip(got, again)), mode


@pytest.mark.parametrize("precision", ["bf16x2", "bf16"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_kernels_match_plain(name, precision):
    dev = _card()
    plan, fac, ne, ni = _linearized(name, dev)
    rng = np.random.default_rng(0)
    rnd = lambda *s: torch.as_tensor(
        rng.standard_normal(s).astype(np.float32), device=dev)
    inputs = dict(vpose=rnd(8, plan.n_img_pad), vi=rnd(128), a_rows=rnd(8, plan.n_pad))
    _check_all(fac.obs.band, fac.acam_t, fac.apt_t, fac.hpi_t, ne, ni, inputs, precision)


@pytest.mark.parametrize("precision", ["bf16x2", "bf16"])
def test_kernels_match_plain_at_the_plan_caps(precision):
    """T = 16384, W = 2048, M = 128, ne = 6: the largest plan the band plan
    builds.  The matvec and back-substitution stage the band's camera
    vector and take 228,356 of the 232,448 bytes of shared memory a CTA
    may have; the rhs + preconditioner 202,244, K1 46,596."""
    dev = _card()
    plan = stress_plan(CAPS)
    assert (plan.T, plan.W, plan.M) == (16384, 2048, 128)
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    lib = _build.load()
    limit = _build.SMEM_LIMIT
    assert lib.fusedmv_schur_smem_bytes(plan.T, plan.M, plan.W, 6, 1, 0, limit) == 228_356
    assert lib.fusedmv_schur_smem_bytes(plan.T, plan.M, plan.W, 6, 0, 1, limit) == 202_244
    assert lib.fusedmv_hpp_smem_bytes(plan.T, plan.M) == 46_596
    band = fusedmv.BandArrays.from_plan(plan, dev)
    a = {k: torch.as_tensor(v, device=dev) for k, v in stress_streams(plan).items()}
    _check_all(band, a["acam_t"], a["apt_t"], a["hpi_t"], 6, 6, a, precision)


def test_wrappers_raise_past_the_shared_memory_limit():
    """A span past what a CTA's shared memory holds raises before any
    launch, naming T, M, W, ne and the mode."""
    import dataclasses

    dev = _card()
    plan, fac, ne, ni = _linearized("eop12", dev)
    band = fac.obs.band
    T = 131_072  # K1: 2 bytes a span row; K2: 10
    big = dataclasses.replace(band, T=T, col_perm=torch.zeros(
        (band.G, T), dtype=torch.int16, device=dev))
    fusedmv.reset_counts()
    with pytest.raises(ValueError, match=f"T={T}, M={band.M}, W={band.W}, ne={ne}"):
        fusedmv.fused_hpp_pass(big, fac.acam_t, fac.apt_t, ne, ni)
    a_rows = torch.zeros((8, band.n_pad), device=dev)
    with pytest.raises(ValueError, match=r"rhs \+ preconditioner.*T=131072"):
        fusedmv.fused_schur_apply(big, fac.acam_t, fac.apt_t, fac.hpi_t, ne, ni,
                                  a_rows=a_rows, with_precond=True)
    assert fusedmv.kernel_launches == {"fused_hpp_pass": 0, "fused_schur_apply": 0}


@pytest.mark.parametrize("name", STRESS)
def test_kernels_match_plain_on_stress_plans(name):
    """One column holding every row of a group, one tie holding nearly a
    whole span, groups without rows and camera-only groups, and the widest
    band the wrappers take (W = 32640), on random streams."""
    dev = _card()
    plan = stress_plan(name)
    band = fusedmv.BandArrays.from_plan(plan, dev)
    a = {k: torch.as_tensor(v, device=dev) for k, v in stress_streams(plan).items()}
    _check_all(band, a["acam_t"], a["apt_t"], a["hpi_t"], 6, 6, a)


def test_reduce_equals_group_ordered_sums():
    """The reduce on random partials, bitwise equal to the same sums taken
    on the host in its order: an image-band output sums the ascending list
    of the groups covering its 128-image block in eight contiguous slices,
    each in order, then adds the slices in order; a lane output sums the
    groups g = s (mod 32) for each slice s in ascending order, then adds
    the 32 slices in order.  Rows past the live ones are zero."""
    dev = _card()
    plan, fac, _, _ = _linearized("img200", dev)
    band = fac.obs.band
    rng = np.random.default_rng(3)
    G, W, rows, live, lane_live = band.G, band.W, 24, 21, 5
    bpart = rng.standard_normal((G, rows, W)).astype(np.float32)
    lpart = rng.standard_normal((G, 8, 128)).astype(np.float32)
    got_b, got_l = fusedmv._reduce_kernel(
        band, torch.as_tensor(bpart, device=dev), torch.as_tensor(lpart, device=dev),
        live, lane_live)
    ib = band.ib.cpu().numpy()
    off, ids = band.cover_off.cpu().numpy(), band.cover_ids.cpu().numpy()
    want_b = np.zeros((rows, band.n_img_pad), np.float32)
    for blk in range(band.n_img_pad // 128):
        cover = ids[off[blk]:off[blk + 1]]
        assert list(cover) == sorted(cover)
        total = np.zeros((live, 128), np.float32)
        for w in range(8):
            part = np.zeros((live, 128), np.float32)
            for g in cover[w * len(cover) // 8:(w + 1) * len(cover) // 8]:
                c = 128 * (blk - ib[g])
                part += bpart[g, :live, c:c + 128]
            total += part
        want_b[:live, 128 * blk:128 * blk + 128] = total
    want_l = np.zeros((8, 128), np.float32)
    for s in range(32):
        part = np.zeros((8, 128), np.float32)
        for g in range(s, G, 32):
            part += lpart[g]
        want_l += part
    want_l[lane_live:] = 0
    assert G >= 32 and band.n_img_pad > W
    np.testing.assert_array_equal(got_b.cpu().numpy(), want_b)
    np.testing.assert_array_equal(got_l.cpu().numpy(), want_l)


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
    # the host loop (the device loop's counts are
    # tests/test_torch_device_loop_cuda.py's)
    opts = schur.SchurOptions(dtype=np.float32, device_loop=False)
    fusedmv.reset_counts()
    on_card = schur.solve_schur(p, opts, compute_covariance=False, device=dev)
    assert fusedmv.kernel_launches["fused_hpp_pass"] == len(on_card.cg_iterations)
    assert fusedmv.plain_calls == {"fused_hpp_pass": 0, "fused_schur_apply": 0}
    on_cpu = schur.solve_schur(p, opts, compute_covariance=False, device="cpu")
    assert on_card.iterations == on_cpu.iterations
    assert on_card.stopped_on == on_cpu.stopped_on
    np.testing.assert_allclose(on_card.x, on_cpu.x, rtol=3e-5, atol=3e-4)
    assert abs(on_card.sigma02 - on_cpu.sigma02) <= 1e-4 * on_cpu.sigma02
