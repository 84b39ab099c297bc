"""The port's projection models and forward-mode Jacobian blocks against
the JAX package's obs_jacobian_blocks, in float64.

Tolerance rtol=1e-10 (atol 1e-12 of each block's largest entry): both
sides are f64 and evaluate the same expressions, differing only in
operation order inside the autodiff."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_eye_bundle_adjustment_tpu.models import projection as jproj
from fish_eye_bundle_adjustment_tpu_torch.models import projection as tproj

from _torch_blocks import jax_block, one_torch_thread  # noqa: F401 (autouse)

MODELS = list(jproj.MODEL_IDS)


def _inputs(selfcal):
    """Per-observation eop/xyz/xy from a synthetic block, and an IOP vector:
    zero distortion (EOP-only) or nonzero radial + decentering terms."""
    p = jax_block("eop12")
    rng = np.random.default_rng(3)
    eop = p.eop0[p.obs_img]
    xyz = p.cnt_xyz[p.obs_pt]
    xy = p.obs_xy
    if selfcal:
        nk = 2
        iop = np.array([1.5, -2.0, 1210.0, 3e-8, -2e-14, 4e-7, -3e-7])
        xy = xy + rng.normal(scale=0.5, size=xy.shape)
    else:
        nk = 1
        iop = np.array([0.0, 0.0, 1200.0, 0.0, 0.0, 0.0])
    return eop, iop, xyz, xy, nk


def _compare(eop, iop, xyz, xy, y_dir, model_id, nk):
    # jitted: one compile per case costs less than eager op-by-op dispatch
    jfn = jax.jit(jax.vmap(
        lambda e, i, x, o, y: jproj.obs_jacobian_blocks(e, i, x, o, y, model_id, nk),
        in_axes=(0, None, 0, 0, None),
    ))
    want = jfn(jnp.asarray(eop), jnp.asarray(iop), jnp.asarray(xyz),
               jnp.asarray(xy), jnp.asarray(y_dir))
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    got = tproj.batched_jacobian_blocks(
        t(eop), t(iop), t(xyz), t(xy), t(y_dir), model_id, nk
    )
    for name, w, g in zip(("r", "J_eop", "J_iop", "J_pt"), want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.dtype == np.float64 and g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(
            g, w, rtol=1e-10, atol=1e-12 * np.abs(w).max(), err_msg=name
        )


@pytest.mark.parametrize("selfcal", [False, True], ids=["eop", "selfcal"])
@pytest.mark.parametrize("model", MODELS)
def test_jacobian_blocks_match_jax(model, selfcal):
    eop, iop, xyz, xy, nk = _inputs(selfcal)
    y_dir = -1.0 if selfcal else 1.0
    _compare(eop, iop, xyz, xy, y_dir, jproj.MODEL_IDS[model], nk)


@pytest.mark.parametrize("model", MODELS)
def test_on_axis_point_is_finite_and_matches(model):
    """R = 0 exactly (point straight down the optical axis): the
    double-where keeps values and derivatives finite, equal to JAX's."""
    eop = np.array([[10.0, 20.0, 500.0, 0.0, 0.0, 0.0],
                    [10.0, 20.0, 500.0, 0.1, -0.05, 0.3]])
    xyz = np.array([[10.0, 20.0, 600.0], [12.0, 25.0, 640.0]])
    xy = np.array([[0.0, 0.0], [3.0, -4.0]])
    iop = np.array([0.5, -0.5, 1200.0, 1e-8, 0.0, 0.0])
    _compare(eop, iop, xyz, xy, 1.0, jproj.MODEL_IDS[model], 1)


def test_single_observation_api_and_float32_dtype():
    """obs_jacobian_blocks keeps the JAX per-observation signature and
    returns blocks in the input dtype (float32 here)."""
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    r, Je, Ji, Jp = tproj.obs_jacobian_blocks(
        f([1.0, 2.0, 1000.0, 3.1, 0.01, 0.2]), f([0.0, 0.0, 1200.0, 1e-8, 0, 0]),
        f([30.0, -20.0, 10.0]), f([50.0, 60.0]), f(1.0), 0, 1,
    )
    assert r.shape == (2,) and Je.shape == (2, 6) and Ji.shape == (2, 6)
    assert Jp.shape == (2, 3)
    assert {t.dtype for t in (r, Je, Ji, Jp)} == {torch.float32}


def test_float32_tangents_stay_float32():
    """jacfwd of a float32 residual runs float32 tangents end to end, as
    JAX's does: the raw jacfwd output is float32 with no cast after it."""
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    eop, iop, xyz = (f([1.0, 2.0, 1000.0, 3.1, 0.01, 0.2]),
                     f([1.5, -2.0, 1200.0, 3e-8, -2e-14, 4e-7, -3e-7]),
                     f([30.0, -20.0, 10.0]))
    for model_id in jproj.MODEL_IDS.values():
        fn = lambda e, i, x: tproj.residual_obs(e, i, x, f([50.0, 60.0]),
                                                 f(-1.0), model_id, 2)
        J = torch.func.jacfwd(fn, argnums=(0, 1, 2))(eop, iop, xyz)
        assert [j.dtype for j in J] == [torch.float32] * 3, model_id
        Jv = torch.func.vmap(torch.func.jacfwd(fn, argnums=(0, 1, 2)),
                             in_dims=(0, None, 0))(eop[None], iop, xyz[None])
        assert [j.dtype for j in Jv] == [torch.float32] * 3, model_id


@pytest.mark.parametrize("model", MODELS)
def test_float32_blocks_match_jax_float32(model):
    """The float32 blocks against JAX's float32 jacfwd on the same inputs.
    Both sides round every intermediate to float32 in a different order, so
    the tolerance is a few float32 ulps of each block's largest entry:
    rtol 2e-5, atol 2e-6 of max |block| (the point derivatives cancel the
    camera-centre ones, so small entries carry that absolute error)."""
    eop, iop, xyz, xy, nk = _inputs(True)
    model_id = jproj.MODEL_IDS[model]
    f32 = lambda a: np.asarray(a, np.float32)
    # float32 inputs keep JAX in float32 (its Python constants are weak)
    jfn = jax.jit(jax.vmap(
        lambda e, i, x, o, y: jproj.obs_jacobian_blocks(e, i, x, o, y, model_id, nk),
        in_axes=(0, None, 0, 0, None),
    ))
    want = jfn(*(jnp.asarray(f32(a)) for a in (eop, iop, xyz, xy, -1.0)))
    got = tproj.batched_jacobian_blocks(
        *(torch.from_numpy(f32(a)) for a in (eop, iop, xyz, xy, -1.0)), model_id, nk
    )
    for name, w, g in zip(("r", "J_eop", "J_iop", "J_pt"), want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == np.float32 and g.dtype == np.float32, name
        np.testing.assert_allclose(
            g, w, rtol=2e-5, atol=2e-6 * np.abs(w).max(), err_msg=name
        )


def test_jacobians_in_threads_match_one_thread():
    """Jacobian passes in several threads at once (a caller's solves in
    threads) equal the pass in one thread, bitwise:
    torch.func's forward mode keeps its nesting in a process global, so
    unserialized threads lose each other's dual levels (zero Jacobian
    columns on the card, a RuntimeError here)."""
    from concurrent.futures import ThreadPoolExecutor

    eop, iop, xyz, xy, nk = _inputs(True)
    args = [torch.tensor(a, dtype=torch.float64) for a in (eop, iop, xyz, xy, -1.0)]
    mid = jproj.MODEL_IDS[MODELS[0]]
    want = tproj.batched_jacobian_blocks(*args, mid, nk)
    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(lambda _: tproj.batched_jacobian_blocks(*args, mid, nk), range(16)))
    for g in got:
        for w, gg in zip(want, g):
            assert torch.equal(gg, w)
