"""Rank functions of the port's data-parallel tests
(``tests/test_torch_parallel*.py`` and the ``mesh=`` cases of the model
tests).  They import no JAX: ``parallel.run_spmd`` spawns ranks that load
them by import path.  Each builds its tensors from the numpy draws it is
given, runs the sharded functions on its mesh and returns what the tests
compare, on every rank alike.  One world of three ranks serves P = 3 and,
through ``make_mesh(2)``, P = 2 (its third rank idles there), so a test
module spawns one world; the 2-D mesh's modules spawn one of four."""

import numpy as np
import torch

from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.optim import make_pack
from gpr_tpu_torch.parallel import (
    fit_restarts_sharded,
    fit_sharded,
    fit_sharded_2d,
    fully_distributed_predict,
    make_mesh,
    make_mesh_2d,
    make_sharded_objective,
    shard_batch,
    sharded_grad,
    sharded_iter_solve,
    sharded_log_evidence,
    sharded_log_evidence_2d,
    sharded_log_evidence_tsqr,
    sharded_pitc_log_evidence,
    sharded_predict_means,
    sharded_predict_variances,
    sharded_value_and_grad,
    sharded_warped_log_evidence,
)

F64 = torch.float64
SIZES = (2, 3)
BLOCK = 8  # rows a block of the plain loop: several blocks a rank


def regression_draws(seed=0, n=37, d=2, m=5):
    """Rows whose count no mesh size divides (so padding applies), their
    targets, inducing points, test rows and the SE-iso hypers."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    return {
        "X": X, "y": np.sin(2.0 * X[:, 0] - X[:, 1])
        + 0.2 * rng.standard_normal(n),
        "Z": rng.standard_normal((m, d)), "Xs": rng.standard_normal((23, d)),
        "coeffs": rng.standard_normal(m), "B": rng.standard_normal((n, 2)),
        "log_ell": 0.2, "log_sf2": 0.3, "sigma2": 0.4,
    }


def t(a, device="cpu", dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def per_size(world, case, *args):
    """{P: case(mesh_P, *args)} for P = 2, 3 on this rank (ranks outside
    the P = 2 mesh skip it)."""
    out = {}
    for size in SIZES:
        mesh = world if size == world.size else make_mesh(size)
        if mesh is not None:
            out[size] = case(mesh, *args)
    return out


def regression_kernel(D, device):
    return SeIso(D["log_ell"], D["log_sf2"], device=device, dtype=F64)


def _regression_case(mesh, D):
    dev = mesh.device
    X, y, Z = t(D["X"]), t(D["y"]), t(D["Z"], dev)
    pack = make_pack(regression_kernel(D, dev), Z, D["sigma2"])
    Xl, yl, ml = shard_batch(mesh, X, y)
    res = {}

    def on_pack(fn, **kw):
        def f(x):
            kernel, z, s2 = pack.unpack(x)
            return fn(kernel, mesh, z, s2, Xl, yl, ml, **kw)
        return sharded_value_and_grad(mesh, f, pack.x0)

    for var in (False, True):
        res[f"evidence/{var}"] = on_pack(sharded_log_evidence,
                                         variational=var, block_size=BLOCK)
        res[f"tsqr/{var}"] = on_pack(sharded_log_evidence_tsqr,
                                     variational=var)
    # the training step on the whole data: the negative Gram evidence
    res["objective"] = make_sharded_objective(mesh, X, y, pack,
                                              block_size=BLOCK)(pack.x0)

    # the gradient over the kernel's leaves, z and sigma2 directly
    kernel = regression_kernel(D, dev)
    z = Z.clone().requires_grad_(True)
    s2 = torch.tensor(D["sigma2"], dtype=F64, device=dev,
                      requires_grad=True)
    val = sharded_log_evidence(kernel, mesh, z, s2, Xl, yl, ml,
                               block_size=BLOCK)
    res["trap"] = (val.detach(), sharded_grad(
        mesh, val, (kernel.log_ell, kernel.log_sf2, z, s2)))

    from gpr_tpu_torch.models.warped import default_warp_params, \
        make_warped_pack

    pack_w, unpack_w = make_warped_pack(
        pack, default_warp_params(2, device=dev, dtype=F64))

    def warped(x):
        kernel, z, s2, wp = unpack_w(x)
        return sharded_warped_log_evidence(kernel, mesh, wp, z, s2, Xl, yl,
                                           ml, block_size=BLOCK)

    res["warped"] = sharded_value_and_grad(
        mesh, warped, pack_w.x0 + 0.05 * torch.arange(
            pack_w.x0.shape[0], dtype=F64, device=dev).sin())

    # PITC: 36 rows, blocks of 6, a whole number of blocks on every rank
    Xp, yp, mp = shard_batch(mesh, X[:36], y[:36])

    def pitc(x):
        kernel, z, s2 = pack.unpack(x)
        return sharded_pitc_log_evidence(kernel, mesh, z, s2, Xp, yp, mp,
                                         block_size=6)

    res["pitc"] = sharded_value_and_grad(mesh, pitc, pack.x0)

    kernel = regression_kernel(D, dev)
    from gpr_tpu_torch.models.streaming import streaming_trained

    trained = streaming_trained(kernel, Z, D["sigma2"], X.to(dev),
                                y.to(dev), block_size=BLOCK)
    m = trained.model
    res["means"] = sharded_predict_means(kernel, mesh, Z, t(D["coeffs"], dev),
                                         t(D["Xs"]), block_size=BLOCK)
    res["variances"] = sharded_predict_variances(
        kernel, mesh, m.inducing.z, m.inducing.chol_km, m.r_mat, t(D["Xs"]),
        D["sigma2"], block_size=BLOCK)

    # training: 3 iterations; every rank's x, gathered, must be bit-equal
    *_, st = fit_sharded(mesh, X, y, pack, block_size=BLOCK, max_iter=3,
                         epsabs=0.0)
    xs = mesh.all_gather(st.x[None])
    res["fit"] = (st.x, st.f, st.n_iter, st.n_evals,
                  bool(torch.all(xs == xs[0])))
    x0s = [pack.x0, pack.x0 + 0.1, pack.x0 - 0.05]
    *_, st, rep = fit_restarts_sharded(
        mesh, X, y, pack, x0s, probe_iters=2, max_iter=4, block_size=BLOCK,
        epsabs=0.0)
    res["restarts"] = (st.x, st.f, list(rep), rep.winner, rep.probe_iters,
                       rep.probe_evals, rep.cont_iters, rep.cont_evals)

    # the iterative solve: anchors are the first 6 rows
    Xl_b, Bl, ml_b = shard_batch(mesh, X, t(D["B"]))
    x, iters, relres = sharded_iter_solve(
        regression_kernel(D, dev), mesh, Xl_b, Bl, D["sigma2"],
        X[:6].to(dev), ml_b, tol=1e-11, max_iter=100, block_size=BLOCK)
    res["iter"] = (x[:X.shape[0]], iters, relres)
    return res


def regression_ranks(world, D):
    return per_size(world, _regression_case, D)


def raising_rank(mesh, bad_rank):
    """Rank ``bad_rank`` raises at once; the others wait in a collective
    for it."""
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    return mesh.allsum(torch.ones(3))


def _laplace_case(mesh, D):
    """Value and gradient (over log_ell, log_sf2, z and the likelihood's
    replicated leaf) of every sharded Laplace, EP and Student-t function,
    the predictor's outputs and the E-step moments."""
    from gpr_tpu_torch.parallel import classify_sharded as cs
    from gpr_tpu_torch.parallel.sharded import gather_rows

    dev = mesh.device
    X = t(D["X"])
    n = X.shape[0]

    def rows(arr, dtype=F64):
        return shard_batch(mesh, X, t(arr, dtype=dtype))[1]

    Xl, _, ml = shard_batch(mesh, X, t(D["classify"]))

    def vg(fn, extra=None):
        kernel = SeIso(0.2, 0.3, device=dev, dtype=F64)
        leaves = [t(D["Z"], dev).requires_grad_(True)]
        if extra is not None:
            leaves.append(t(extra, dev).requires_grad_(True))
        val = fn(kernel, *leaves)
        return val.detach(), sharded_grad(
            mesh, val, (kernel.log_ell, kernel.log_sf2, *leaves))

    y, counts = rows(D["classify"]), rows(D["poisson"])
    lam = torch.where(ml > 0, rows(D["lam"]), 1.0)  # 1 on padding, as fit_t
    labels = rows(D["ordinal"], torch.int64)
    res = {
        "classify": vg(lambda k, z: cs.sharded_classify_log_evidence(
            k, mesh, z, Xl, y, ml)),
        "classify_stream": vg(lambda k, z: cs.sharded_classify_log_evidence(
            k, mesh, z, Xl, y, ml, block_size=BLOCK)),
        "ep": vg(lambda k, z: cs.sharded_ep_log_evidence(
            k, mesh, z, Xl, y, ml)),
        "poisson": vg(lambda k, z: cs.sharded_poisson_log_evidence(
            k, mesh, z, Xl, counts, ml,
            log_exposure=rows(D["exposure"]))),
        "binomial": vg(lambda k, z: cs.sharded_binomial_log_evidence(
            k, mesh, z, Xl, rows(D["binomial"]), rows(D["trials"]), ml)),
        "negbin": vg(lambda k, z, r: cs.sharded_negbin_log_evidence(
            k, mesh, z, Xl, rows(D["negbin"]), r, ml), np.float64(2.0)),
        "multiclass": vg(lambda k, z: cs.sharded_multiclass_log_evidence(
            k, mesh, z, Xl, labels, 4, ml)),
        "multiclass_stream": vg(
            lambda k, z: cs.sharded_multiclass_log_evidence(
                k, mesh, z, Xl, labels, 4, ml, block_size=BLOCK)),
        "ordinal": vg(lambda k, z, c: cs.sharded_ordinal_log_evidence(
            k, mesh, z, Xl, labels, c, ml), D["cut_raw"]),
        "hetero": vg(lambda k, z, s2: cs.sharded_hetero_log_evidence(
            k, mesh, z, s2 / lam, Xl, rows(D["y"]), ml),
            np.float64(0.3)),
    }
    kernel = SeIso(0.2, 0.3, device=dev, dtype=F64)
    Z = t(D["Z"], dev)
    res["predict"] = cs.sharded_classify_predict(kernel, mesh, Z, Xl, y,
                                                 t(D["Xs"]), ml)
    mu, var = cs.sharded_t_moments(kernel, mesh, Z, 0.3, Xl, rows(D["y"]),
                                   lam, ml)
    res["t_moments"] = (gather_rows(mesh, mu, n), gather_rows(mesh, var, n))
    return res


def laplace_ranks(world, D):
    return per_size(world, _laplace_case, D)


def _fit_call(kind, X, y, Z, mesh=None, **kw):
    """One model fit of ``kind`` from an SE-iso (0.2, 0.3) pack at Z, on
    ``mesh`` or (None) on one device; returns the fit's outputs."""
    from gpr_tpu_torch.models import (
        classify,
        classify_ep,
        classify_multi,
        ordinal,
        robust,
    )

    dev = X.device if mesh is None else mesh.device
    robust_fit = kind == "robust"
    pack = make_pack(SeIso(0.2, 0.3, device=dev, dtype=F64), Z.to(dev),
                     0.4 if robust_fit else 1.0, learn_sigma2=robust_fit)
    if kind == "classify":
        return classify.fit_classify(X, y, pack, mesh=mesh, **kw)
    if kind == "ep":
        return classify_ep.fit_classify_ep(X, y, pack, mesh=mesh, **kw)
    if kind == "multi":
        return classify_multi.fit_classify_multi(X, y, pack, 3, mesh=mesh,
                                                 **kw)
    if kind == "ordinal":
        return ordinal.fit_ordinal(X, y, pack, kw.pop("cut_raw0"),
                                   mesh=mesh, **kw)
    return robust.fit_t(X, y, pack, mesh=mesh, **kw)


def mesh_fit_rank(mesh, kind, X, y, Z, kw):
    """``_fit_call`` on this rank's mesh: the fit's outputs and whether
    the final x is bit-equal on every rank."""
    out = _fit_call(kind, X, y, Z, mesh=mesh, **kw)
    xs = mesh.all_gather(out[-1].x[None])
    return out[-1].x, out[-1].f, bool(torch.all(xs == xs[0])), out[-2]


def check_mesh_fit(kind, X, y, Z, rtol=1e-8, **kw):
    """Run ``kind``'s fit with a P = 2 mesh on gloo CPU ranks and on one
    device; the final x (and the fit's last output before the state: z,
    the cutpoint raws or lam_hat) must agree within ``rtol`` and x must be
    bit-equal on both ranks."""
    from gpr_tpu_torch.parallel import run_spmd

    x, f, equal, last = run_spmd(mesh_fit_rank, 2, kind, X, y, Z, kw,
                                 platform="cpu")
    single = _fit_call(kind, X, y, Z, **kw)
    assert equal, "x differs between the ranks"
    for got, want in ((x, single[-1].x), (f, single[-1].f),
                      (last, single[-2])):
        want = want.detach()
        err = float(torch.max(torch.abs(got - want)))
        assert err <= rtol * max(float(torch.max(torch.abs(want))), 1e-300)


# ---------------------------------------------------------------------------
# The 2-D (data x model) mesh: ``tests/test_torch_dist_chol.py`` and
# ``tests/test_torch_mesh2d.py``.  One world of four ranks serves 2x2 and,
# through ``make_mesh_2d``, 1x2, 2x1 and 1x4 (ranks outside a mesh skip
# it).

def per_shape(shapes, case, *args):
    """{(D, M): case(mesh, *args)} on this rank for each shape (every rank
    makes every mesh, in one order; ranks outside one skip its case)."""
    out = {}
    for shape in shapes:
        mesh = make_mesh_2d(*shape)
        if mesh is not None:
            out[shape] = case(mesh, *args)
    return out


def dist_chol_draws(seed=0, m=16, k=3):
    """An SPD A = I + W W'/m, right-hand sides (m, 4k) (k columns a member
    at p = 4, 2k at p = 2), a square W, a symmetric G, a vector u and the
    gradient case's leaves."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, m))
    h = rng.standard_normal((m, m))
    return {"A": np.eye(m) + w @ w.T / m, "B": rng.standard_normal((m, 4 * k)),
            "W": rng.standard_normal((m, m)), "G": h @ h.T / m,
            "u": rng.standard_normal(m), "L": rng.standard_normal((m, m)),
            "H": rng.standard_normal((m, 4)), "C": rng.standard_normal((m, m))}


def dist_chol_value(D, L, u, H, chol, log_det, lower_t, whiten_dot, cols):
    """log det(A) + |R^-T u|^2 + sum(R^-T G R^-1 * C) with A = L L'/m + I
    = R'R, G = H H', from the column-block functions (or dense ones, with
    ``cols`` every column); ``whiten_dot(r, g, c)`` gives the last term
    from blocks of R, G and C."""
    m = L.shape[0]
    A = L @ L.T / m + torch.eye(m, dtype=F64)
    r = chol(A[:, cols])
    tt = lower_t(r, u)
    return (log_det(r) + torch.dot(tt, tt)
            + whiten_dot(r, (H @ H.T)[:, cols], t(D["C"])[:, cols]))


def _dist_chol_case(mesh, D):
    from gpr_tpu_torch.parallel import dist_chol as dc

    model = mesh.model
    p, j = model.size, model.rank
    A, B, W, G = (t(D[name]) for name in ("A", "B", "W", "G"))
    m_t = A.shape[0] // p
    cols = slice(j * m_t, (j + 1) * m_t)
    k = B.shape[1] // p
    own = B[:, j * k:(j + 1) * k]

    def gather(x):
        return model.all_gather(x, dim=1)

    r_j = dc.dist_cholesky_upper(A[:, cols], model)
    R = gather(r_j)
    res = {
        "chol": R, "log_det": dc.dist_log_det_tri(r_j, model),
        "lower_t": dc.dist_solve_lower_t(r_j, t(D["u"]), model),
        "lower_cols": gather(dc.dist_solve_lower_cols(r_j, own, model)),
        "upper_cols": gather(dc.dist_solve_upper_cols(r_j, own, model)),
        "inverse": gather(dc.dist_spd_inverse_cols(r_j, model)),
        "transpose": gather(dc.dist_transpose_cols(W[:, cols], model)),
        "whiten": gather(dc.dist_whiten_cols(r_j, G[:, cols], model)),
        "whiten_replicated": gather(dc.whiten_cols_replicated(
            R, G[:, cols], model)),
    }
    leaves = [t(D[name]).requires_grad_(True) for name in ("L", "u", "H")]
    val = dist_chol_value(
        D, *leaves, lambda a: dc.dist_cholesky_upper(a, model),
        lambda r: dc.dist_log_det_tri(r, model),
        lambda r, u: dc.dist_solve_lower_t(r, u, model),
        lambda r, g, c: model.allsum(torch.sum(
            dc.dist_whiten_cols(r, g, model) * c)), cols)
    res["grad"] = (val.detach(), sharded_grad(mesh, val, leaves))
    return res


def dist_chol_ranks(world, D):
    return per_shape(((2, 2), (1, 4)), _dist_chol_case, D)


MODES_2D = {  # sharded_log_evidence_2d's modes by name
    "replicated": {},
    "epilogue": {"epilogue": "distributed"},
    "inducing-raw": {"inducing": "distributed", "factorization": "raw"},
    "inducing-whitened": {"inducing": "distributed",
                          "factorization": "whitened"},
}
F32_MODES_2D = ("replicated", "epilogue", "inducing-whitened")


def mesh2d_draws(seed=0, n=37, d=3):
    """``regression_draws`` (37 rows, which D = 2 does not divide) in 3
    inputs with 8 and 13 inducing points (K(Z, Z)'s condition ~1e3: the
    fully distributed mode forms Km^-1 and B^-1, whose rounding a 1e6
    condition lifts above 1e-10) and se_fat's rows."""
    D = regression_draws(seed, n=n, d=d, m=8)
    rng = np.random.default_rng(seed + 1)
    D["Z13"] = rng.standard_normal((13, d))
    D["X_fat"] = rng.standard_normal((n, 3))
    return D


def _vg_2d(mesh, pack, data, dtype=F64, **kw):
    """(value, packed gradient) of the 2-D evidence at the pack's x0."""
    def f(x):
        kernel, z, s2 = pack.unpack(x)
        return sharded_log_evidence_2d(kernel, mesh, z, s2, *data,
                                       block_size=BLOCK, **kw)

    return sharded_value_and_grad(mesh, f, pack.x0)


def _mesh2d_case(mesh, D, fat):
    from gpr_tpu_torch.convert import from_jax_params

    dev = mesh.device
    X, y = t(D["X"]), t(D["y"])
    data = shard_batch(mesh, X, y)
    full = mesh.shape == {"data": 2, "model": 2}
    res = {}

    def pack_of(Z, dtype=F64):
        return make_pack(SeIso(D["log_ell"], D["log_sf2"], device=dev,
                               dtype=dtype), t(Z, dev, dtype), D["sigma2"])

    for mode, kw in MODES_2D.items():
        for var in ((False, True) if full else (False,)):
            res[f"ev/{mode}/{var}"] = _vg_2d(mesh, pack_of(D["Z"]), data,
                                             variational=var, **kw)
    if mesh.shape["model"] == 2:
        for mode in ("inducing-raw", "inducing-whitened"):
            res[f"m13/{mode}"] = _vg_2d(mesh, pack_of(D["Z13"]), data,
                                        **MODES_2D[mode])
        res["predict/13"] = fully_distributed_predict(
            regression_kernel(D, dev), mesh, t(D["Z13"], dev), D["sigma2"],
            X, y, t(D["Xs"]), block_size=BLOCK)
    if not full:
        return res
    res["predict/8"] = fully_distributed_predict(
        regression_kernel(D, dev), mesh, t(D["Z"], dev), D["sigma2"], X, y,
        t(D["Xs"]), block_size=BLOCK)
    # se_fat (tproj, hetero and multiscales on), variational
    kernel, z, s2 = from_jax_params(fat["params"], fat["Z"], 0.5,
                                    device=dev, dtype=F64, family="se_fat")
    fat_data = shard_batch(mesh, t(D["X_fat"]), y)
    for mode in ("replicated", "inducing-raw"):
        res[f"se_fat/{mode}"] = _vg_2d(mesh, make_pack(kernel, z, 0.5),
                                       fat_data, variational=True,
                                       **MODES_2D[mode])
    # f32: the whitened-direct Gram, its distributed epilogue, and the
    # fully distributed whitened factorization
    data32 = tuple(v.float() for v in data)
    for mode in F32_MODES_2D:
        res[f"f32/{mode}"] = _vg_2d(mesh, pack_of(D["Z"], torch.float32),
                                    data32, variational=True,
                                    **MODES_2D[mode])
    # the gradient over the kernel's leaves, z and sigma2 directly
    kernel = regression_kernel(D, dev)
    z = t(D["Z"], dev).requires_grad_(True)
    s2 = torch.tensor(D["sigma2"], dtype=F64, device=dev, requires_grad=True)
    val = sharded_log_evidence_2d(kernel, mesh, z, s2, *data,
                                  block_size=BLOCK)
    res["trap"] = (val.detach(), sharded_grad(
        mesh, val, (kernel.log_ell, kernel.log_sf2, z, s2)))
    try:
        sharded_log_evidence_2d(kernel, mesh, z[:7], s2, *data)
        res["refusal"] = None
    except ValueError as exc:
        res["refusal"] = str(exc)
    # training: 3 iterations, and 3 starts probed over the 4 ranks
    pack = pack_of(D["Z"])
    *_, st = fit_sharded_2d(mesh, X, y, pack, block_size=BLOCK, max_iter=3,
                            epsabs=0.0)
    xs = mesh.all.all_gather(st.x[None])
    res["fit"] = (st.x, st.f, st.n_iter, st.n_evals,
                  bool(torch.all(xs == xs[0])))
    x0s = [pack.x0, pack.x0 + 0.1, pack.x0 - 0.05]
    *_, st, rep = fit_restarts_sharded(
        mesh, X, y, pack, x0s, probe_iters=2, max_iter=4, block_size=BLOCK,
        epsabs=0.0)
    xs = mesh.all.all_gather(st.x[None])
    res["restarts"] = (st.x, st.f, list(rep), rep.winner, rep.probe_iters,
                       rep.probe_evals, rep.cont_iters, rep.cont_evals,
                       bool(torch.all(xs == xs[0])))
    return res


def mesh2d_ranks(world, D, fat):
    out = per_shape(((2, 2), (1, 2), (2, 1)), _mesh2d_case, D, fat)
    try:  # a mesh larger than the world
        make_mesh_2d(3, 2)
        out["too_big"] = None
    except ValueError as exc:
        out["too_big"] = str(exc)
    return out


def raising_rank_2d(world, bad_rank, D):
    """On a 2x2 mesh rank ``bad_rank`` raises at once; the others wait in
    the 2-D evidence's collectives for it."""
    mesh = make_mesh_2d(2, 2)
    if world.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    X, y = t(D["X"]), t(D["y"])
    return sharded_log_evidence_2d(regression_kernel(D, mesh.device), mesh,
                                   t(D["Z"]), D["sigma2"],
                                   *shard_batch(mesh, X, y))
