"""The port's fused operator (ops/fusedmv.py) against the JAX package's
Pallas kernels on the same folded streams.

On the CPU the port's wrappers run the plain PyTorch versions; the JAX
kernels run in interpret mode at precision="bf16x2".  Tolerance: relative
norm < 5e-4 on every output the solver glue reads (lane partials summed),
the budget tests/test_fusedmv.py gives the TPU kernel against the exact
XLA path -- the port computes in plain f32, so the gap is the TPU kernel's
bf16x2 operand split (~1.5e-5) plus f32 summation order.

The CUDA kernels themselves run only on a card: tests/test_torch_fusedmv_cuda.py
(marked gpu, no JAX import) compares them with the plain versions there."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_eye_bundle_adjustment_tpu.ops import fusedmv as jfused
from fish_eye_bundle_adjustment_tpu.solver import schur as jschur
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout
from fish_eye_bundle_adjustment_tpu_torch.ops import fusedmv as tfused
from fish_eye_bundle_adjustment_tpu_torch.solver import schur as tschur
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout as TLayout

from _torch_blocks import jax_block, to_port

RTOL = 5e-4


@functools.lru_cache(maxsize=None)
def _linearized(name):
    """The JAX band plan of a test block, and the folded streams and
    Hpp^-1 of the port's linearization at the initial point: both
    operators then run on the same arrays.  (The port's linearization is
    held to the JAX package's in tests/test_torch_schur.py; taking it here
    saves a JAX compile per block.)"""
    p = jax_block(name)
    layout = ParamLayout(p)
    opts = jschur.SchurOptions(
        dtype=np.float32, fused=True, fused_precision_mv="bf16x2"
    )
    plan = jschur.make_band_plan(p, layout, opts)
    band_j = jfused.BandArrays.from_plan(plan)

    tp = to_port(p)
    tl = TLayout(tp)
    topts = tschur.SchurOptions(dtype=np.float32)
    tobs = tschur.ObsData.from_problem(
        tp, tl, tschur.make_band_plan(tp, tl, topts), dtype=np.float32
    )
    x0 = torch.from_numpy(tl.initial().astype(np.float32))
    fac = tschur.SchurKernel(tl, topts).linearize(
        x0 * tl.scale_like(x0), tobs, lam=torch.zeros(())
    )
    return plan, band_j, fac, layout.n_eop, layout.n_iop


def _inputs(name, seed=0):
    plan, band_j, fac, ne, ni = _linearized(name)
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.array(a, np.float32)
    arrs = dict(
        acam_t=f32(fac.acam_t), apt_t=f32(fac.apt_t), hpi_t=f32(fac.hpi_t),
        vpose=f32(rng.standard_normal((8, plan.n_img_pad))),
        vi=f32(rng.standard_normal(128)),
        a_rows=f32(rng.standard_normal((8, plan.n_pad))),
    )
    return plan, band_j, ne, ni, arrs


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _glue_outputs(outs, plan, ne, ni):
    """What the solver glue reads from each output, lanes summed."""
    nt, n_img = plan.n_tie, plan.n_img
    out_pose, out_iop, y = (np.asarray(o) for o in outs[:3])
    read = {"pose": out_pose[:ne, :n_img], "y": y[:3, :nt]}
    if ni:
        read["iop"] = out_iop[:ni].sum(axis=1)
    if len(outs) == 5:
        p21, i55 = np.asarray(outs[3]), np.asarray(outs[4])
        read["p21"] = p21[: ne * (ne + 1) // 2, :n_img]
        if ni:
            read["i55"] = i55[: ni * (ni + 1) // 2].sum(axis=1)
    return read


MODES = {
    # name -> (vpose/vi given, a_rows given, with_precond)
    "matvec": (True, False, False),
    "rhs_precond": (False, True, True),
    "backsub": (True, True, False),
}


NAMES = ["eop12", "selfcal16", "partial12"]


@pytest.mark.parametrize("name", NAMES)
def test_hpp_pass_matches_pallas(name):
    plan, band_j, ne, ni, a = _inputs(name)
    want = jax.jit(functools.partial(
        jfused.fused_hpp_pass, ne=ne, ni=ni, precision="bf16x2", interpret=True
    ))(band_j, jnp.asarray(a["acam_t"]), jnp.asarray(a["apt_t"]))
    band = tfused.BandArrays.from_plan(plan, "cpu")
    before = tfused.plain_calls["fused_hpp_pass"]
    got = tfused.fused_hpp_pass(
        band, torch.from_numpy(a["acam_t"]), torch.from_numpy(a["apt_t"]), ne, ni
    )
    assert tfused.plain_calls["fused_hpp_pass"] == before + 1
    hs, de, di = (g.numpy() for g in got)
    assert hs.shape == (8, plan.G * plan.M) and de.shape == (8, plan.n_img_pad)
    assert di.shape == (8, 128)
    w_hs, w_de, w_di = (np.asarray(w) for w in want)
    assert _rel(hs[:6, : plan.n_tie], w_hs[:6, : plan.n_tie]) < RTOL
    assert _rel(de[:ne, : plan.n_img], w_de[:ne, : plan.n_img]) < RTOL
    if ni:
        assert _rel(di[:ni].sum(1), w_di[:ni].sum(1)) < RTOL
    # the glue drops the padded rank columns; the operator leaves them 0
    assert not hs[:, plan.n_tie :].any()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_schur_apply_matches_pallas(name, mode):
    plan, band_j, ne, ni, a = _inputs(name)
    with_v, with_a, with_precond = MODES[mode]
    kw = {}
    if with_v:
        kw.update(vpose=a["vpose"], vi=a["vi"])
    if with_a:
        kw["a_rows"] = a["a_rows"]
    streams = (a["acam_t"], a["apt_t"], a["hpi_t"])

    jfn = jax.jit(functools.partial(
        jfused.fused_schur_apply, ne=ne, ni=ni, precision="bf16x2",
        interpret=True, with_precond=with_precond,
    ))
    want = jfn(band_j, *map(jnp.asarray, streams),
               **{k: jnp.asarray(v) for k, v in kw.items()})
    band = tfused.BandArrays.from_plan(plan, "cpu")
    got = tfused.fused_schur_apply(
        band, *map(torch.from_numpy, streams), ne, ni,
        with_precond=with_precond,
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
    assert len(got) == (5 if with_precond else 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
    got_r = _glue_outputs([g.numpy() for g in got], plan, ne, ni)
    want_r = _glue_outputs(want, plan, ne, ni)
    assert got_r.keys() == want_r.keys()
    for key in want_r:
        assert _rel(got_r[key], want_r[key]) < RTOL, key


def test_wrappers_refuse_other_devices():
    """The wrappers dispatch on the device: CPU -> plain version, CUDA ->
    kernel; anything else (or a mix) raises instead of falling back."""
    plan, _, ne, ni, a = _inputs("eop12")
    band = tfused.BandArrays.from_plan(plan, "cpu")
    acam = torch.from_numpy(a["acam_t"]).to("meta")
    apt = torch.from_numpy(a["apt_t"])
    with pytest.raises(ValueError):
        tfused.fused_hpp_pass(band, acam, apt, ne, ni)
    with pytest.raises(ValueError):
        tfused.fused_schur_apply(
            band, acam, apt, torch.from_numpy(a["hpi_t"]), ne, ni,
            a_rows=torch.from_numpy(a["a_rows"]),
        )
