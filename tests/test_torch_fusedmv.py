"""The port's fused operator (ops/fusedmv.py) against the JAX package's
Pallas kernels on the same folded streams.

On the CPU the port's wrappers run the plain PyTorch versions; the JAX
kernels run in interpret mode.  Both sides run at the same precision:
"bf16", "bf16x2", or neither given (both wrappers' default, "bf16x2").
Tolerance: relative norm < 1e-5 on every output the solver glue reads
(lane partials summed).  Both round the same operands the same way, so
the gap is f32 summation order and the rare value that lies within an f32
rounding of a bf16 boundary (at most 6.1e-6 here, on selfcal16's IOP rows
of the reduced rhs).  test_unrounded_operands_fail_the_parity_tests is the
control: the plain versions with the rounding taken out must fail these
tests -- every case at "bf16" (a bf16 operand is off by up to 2^-9), and
selfcal16's reduced rhs at "bf16x2", whose hi + lo pair is off by at most
2^-17, within the f32 summation noise of the other outputs.

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

from _torch_blocks import (  # noqa: F401 (one_torch_thread: autouse)
    BLOCKS, STRESS, jax_block, one_torch_thread, stress_plan, to_port,
)

RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _linearized(name):
    """The JAX band plan of a test block, and the folded streams and
    Hpp^-1 of the port's linearization at the initial point: both
    operators then run on the same arrays.  (The port's linearization is
    held to the JAX package's in tests/test_torch_schur.py; taking it here
    saves a JAX compile per block.)"""
    p = jax_block(name)
    layout = ParamLayout(p)
    opts = jschur.SchurOptions(dtype=np.float32, fused=True)
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
# precision given to both packages' wrappers alike (None: neither is given one)
PRECISIONS = {"bf16": "bf16", "bf16x2": "bf16x2", "defaults": None}


def _prec(prec):
    p = PRECISIONS[prec]
    return {} if p is None else {"precision": p}


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("name", NAMES)
def test_hpp_pass_matches_pallas(name, prec):
    plan, band_j, ne, ni, a = _inputs(name)
    want = jax.jit(functools.partial(
        jfused.fused_hpp_pass, ne=ne, ni=ni, interpret=True, **_prec(prec)
    ))(band_j, jnp.asarray(a["acam_t"]), jnp.asarray(a["apt_t"]))
    band = tfused.BandArrays.from_plan(plan, "cpu")
    before = tfused.plain_calls["fused_hpp_pass"]
    got = tfused.fused_hpp_pass(
        band, torch.from_numpy(a["acam_t"]), torch.from_numpy(a["apt_t"]), ne, ni,
        **_prec(prec)
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


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_schur_apply_matches_pallas(name, mode, prec):
    plan, band_j, ne, ni, a = _inputs(name)
    with_v, with_a, with_precond = MODES[mode]
    kw = {}
    if with_v:
        kw.update(vpose=a["vpose"], vi=a["vi"])
    if with_a:
        kw["a_rows"] = a["a_rows"]
    streams = (a["acam_t"], a["apt_t"], a["hpi_t"])

    jfn = jax.jit(functools.partial(
        jfused.fused_schur_apply, ne=ne, ni=ni, interpret=True,
        with_precond=with_precond, **_prec(prec),
    ))
    want = jfn(band_j, *map(jnp.asarray, streams),
               **{k: jnp.asarray(v) for k, v in kw.items()})
    band = tfused.BandArrays.from_plan(plan, "cpu")
    got = tfused.fused_schur_apply(
        band, *map(torch.from_numpy, streams), ne, ni,
        with_precond=with_precond, **_prec(prec),
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


@pytest.mark.parametrize("prec", ["bf16", "bf16x2"])
def test_unrounded_operands_fail_the_parity_tests(prec, monkeypatch):
    """The control of the tests above: with the operand rounding taken out
    of the plain versions, they miss RTOL."""
    monkeypatch.setattr(tfused, "_round", lambda x, precision: x)
    cases = ([("hpp", name, None) for name in NAMES]
             + [("schur", name, mode) for name in NAMES for mode in MODES]
             if prec == "bf16" else [("schur", "selfcal16", "rhs_precond")])
    for test, name, mode in cases:
        with pytest.raises(AssertionError):
            if test == "hpp":
                test_hpp_pass_matches_pallas(name, prec)
            else:
                test_schur_apply_matches_pallas(name, mode, prec)


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


# ---------------------------------------------------------------------------
# the kernels' host index (ops/fusedmv.group_index) against a brute force
# ---------------------------------------------------------------------------
def _port_plan(name):
    """The port's band plan of a test block (synth + solver of the port),
    or of a stress stream of tests/_torch_blocks.py."""
    if name in STRESS:
        return stress_plan(name)
    from fish_eye_bundle_adjustment_tpu_torch.synth import make_block

    kw, opts = INDEX_BLOCKS[name]
    p = make_block(model="fisheye", **kw).problem
    return tschur.make_band_plan(p, TLayout(p), tschur.SchurOptions(dtype=np.float32, **opts))


INDEX_BLOCKS = {
    name: (BLOCKS[name], {}) for name in NAMES
} | {
    # several groups: 16 tie ranks a group
    "groups40": (dict(n_img=40, n_pts=600, seed=3, control_frac=0.05,
                      settings_overrides={"inner_constraints": False}), dict(band_M=16)),
}


@pytest.mark.parametrize("name", list(INDEX_BLOCKS) + list(STRESS))
def test_group_index_matches_brute_force(name):
    plan = _port_plan(name)
    idx = tfused.group_index(plan)
    G, M, T, W = plan.G, plan.M, plan.T, plan.W
    assert idx["tie_off"].shape == (G, M + 1) and idx["col_perm"].shape == (G, T)
    assert idx["col_off"].shape == (G, W + 1) and idx["col_perm"].dtype == np.int16
    row_group = np.full(plan.n_pad, -1)
    control_only = 0
    for g in range(G):
        start = int(plan.row_start[g])
        lo = max(int(plan.first_row[g]), start)
        hi = min(int(plan.end_row[g]), start + T)
        row_group[lo:hi] = g
        rel, img = plan.rel[lo:hi], plan.imgrow[lo:hi]
        control_only += bool(hi > lo and (rel < 0).all())
        toff = idx["tie_off"][g]
        assert toff[0] == 0 and (np.diff(toff) >= 0).all()
        for m in range(M):  # each slot's rows are exactly its run
            np.testing.assert_array_equal(np.flatnonzero(rel == m), np.arange(toff[m], toff[m + 1]))
        coff, perm = idx["col_off"][g], idx["col_perm"][g]
        base = int(plan.img_base[g])
        assert coff[0] == 0 and (np.diff(coff) >= 0).all()
        for c in range(W):  # each column's rows are its run, in row order
            want = [i for i in range(hi - lo) if img[i] >= 0 and img[i] - base == c]
            np.testing.assert_array_equal(perm[coff[c]:coff[c + 1]], want)
        assert (perm[coff[W]:] == -1).all()
    np.testing.assert_array_equal(idx["row_group"], row_group)
    ib, wb = plan.img_base // 128, W // 128
    for b in range(plan.n_img_pad // 128):
        want = [g for g in range(G) if ib[g] <= b < ib[g] + wb]
        np.testing.assert_array_equal(
            idx["cover_ids"][idx["cover_off"][b]:idx["cover_off"][b + 1]], want)
    if name in ("eop12", "empty_groups"):  # control observations: camera-only groups
        assert control_only >= 1
    if name == "groups40":
        assert G >= 4
    if name == "empty_groups":
        assert (plan.first_row == plan.end_row).sum() >= 6


def test_group_index_raises_past_its_limits():
    """The index refuses spans past int16 row numbers, bands that are not
    whole 128-image blocks, and a group whose rows are not in tie order."""
    import dataclasses

    plan = _port_plan("groups40")
    with pytest.raises(ValueError, match="T <= 32768"):
        tfused.group_index(dataclasses.replace(plan, T=32768 + 128))
    with pytest.raises(ValueError, match="W % 128"):
        tfused.group_index(dataclasses.replace(plan, W=plan.W + 64))
    lo, hi = int(plan.first_row[0]), int(plan.end_row[0])  # a group of ties
    rel = plan.rel.copy()
    rel[lo:hi] = rel[lo:hi][::-1]
    assert (np.diff(rel[lo:hi]) < 0).any()
    with pytest.raises(ValueError, match="not sorted by tie slot"):
        tfused.group_index(dataclasses.replace(plan, rel=rel))
