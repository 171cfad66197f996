"""The 2-D (data x model) mesh: tensor parallelism over the m axis, the
counterpart of ``gpr_tpu/parallel/mesh2d.py``.

The 1-D path (``sharded.py``) replicates all m-sized work.  Here the two
O(n m^2) GEMMs of a pass (V = Knm U^-1 and the Gram) shard over a second,
model axis, and the evidence stays exact.  Per (data i, model j) rank and
row block:

    knm   = K(X_block, Z)                   duplicated over model
    V_.j  = knm @ U^-1[:, cols_j]           GEMM #1, model-sharded
    rowsq = allsum_model(rowsq(V_.j))       the block's rows over the axis
    r, s, 1/s                               elementwise
    G_.j += knm' (1/s * knm[:, cols_j])     GEMM #2, model-sharded
    u    += knm' (y / s)                    duplicated (cheap)

then one all-reduce over the data axis, and the epilogue: replicated (the
Gram's column blocks all-gathered, whitened, I + G~ factored) or
distributed (``epilogue="distributed"``: the blocks stay sharded and
``dist_chol`` factors them).  ``inducing="distributed"`` holds no m x m
matrix anywhere: Km as column blocks (``kernels.base.k_upper_cols``),
factored by the distributed block Cholesky, rowsq(V) = rowdot(Knm, Knm
Km^-1) from column blocks of Km^-1.

Accumulators take the rows' dtype, as everywhere in the port (JAX's follow
its x64 flag).  With f64 the raw Gram is accumulated and both GEMMs shard.
In f32 the raw-Gram sandwich loses definiteness (the JAX package measured
-3.2 on an ill-conditioned example), so the replicated-inducing modes
accumulate the whitened Gram (the full V a rank: the V GEMM duplicates,
only the Gram GEMM shards) and the fully distributed mode factors I + G~
from two-sum compensated raw blocks (``factorization="whitened"``).

Each function runs on every rank of a :class:`~.spmd.Mesh2D`
(``spmd.make_mesh_2d``).  ``sharded_log_evidence_2d`` takes the rank's
rows (``sharded.shard_batch(mesh, X, y)``: the data member's block);
``fully_distributed_predict`` and ``fit_sharded_2d`` take the whole data.
Gradients come from ``spmd.sharded_value_and_grad`` / ``sharded_grad``
over the whole mesh.  When autograd records, each row block runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint(body)``).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..config import config
from ..kernels.base import k_upper_cols
from ..models.fitc import LOG_2PI, calc_inducing
from ..models.stream_grad import _two_sum
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri,
)
from .dist_chol import (
    _eye_cols,
    dist_cholesky_upper,
    dist_log_det_tri,
    dist_solve_lower_t,
    dist_solve_upper_cols,
    dist_spd_inverse_cols,
    dist_whiten_cols,
    whiten_cols_replicated,
)
from .sharded import (
    _local_padded,
    gather_rows,
    local_rows,
    pad_to_shards,
    shard_batch,
)
from .spmd import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh2D,
    allsum_many,
    make_mesh_2d,
    sharded_value_and_grad,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "fit_sharded_2d",
    "fully_distributed_predict",
    "make_mesh_2d",
    "sharded_log_evidence_2d",
]


def _scan(body, X, y, mask, block_size: int, comp: bool = False):
    """The sums over this rank's row blocks of ``body(x_b, y_b, mask_b)``'s
    terms (a tuple of tensors), each block under ``torch.utils.checkpoint``
    when autograd records; ``comp`` keeps two-sum pairs, folded at the
    end.  Every rank of a data member runs the same blocks."""
    record = torch.is_grad_enabled()
    bs = min(block_size, X.shape[0])
    acc = None
    for start in range(0, X.shape[0], bs):
        args = (X[start:start + bs], y[start:start + bs],
                mask[start:start + bs])
        terms = (checkpoint(body, *args, use_reentrant=False) if record
                 else body(*args))
        if acc is None:
            acc = [(t, torch.zeros_like(t)) for t in terms] if comp \
                else list(terms)
        elif comp:
            acc = [_two_sum(hi, lo, t) for (hi, lo), t in zip(acc, terms)]
        else:
            acc = [a + t for a, t in zip(acc, terms)]
    return [hi + lo for hi, lo in acc] if comp else acc


def _scalars(live, s, is_, y_b, r, mask_b):
    """The block's sum log s, sum is y^2, sum is r and live-row count."""
    return torch.stack([torch.sum(torch.where(live, torch.log(s), 0.0)),
                        torch.sum(is_ * y_b * y_b), torch.sum(is_ * r),
                        torch.sum(mask_b)])


def _evidence(log_det_ratio, scal, t, variational: bool):
    """The FITC evidence from log det(B) - log det(Km), the summed scalars
    and t = R^-T u."""
    lds, yiy, isr, cnt = scal.unbind()
    l1 = -0.5 * (log_det_ratio + lds + cnt * LOG_2PI)
    if variational:
        l1 = l1 - 0.5 * isr
    # quad >= 0 mathematically; clamp the f32 cancellation overshoot
    return l1 - 0.5 * torch.clamp(yiy - torch.dot(t, t), min=0.0)


def sharded_log_evidence_2d(kernel, mesh: Mesh2D, z, sigma2, X, y,
                            mask=None, *, variational: bool = False,
                            block_size: int = 8192,
                            jitter: float | None = None,
                            epilogue: str = "replicated",
                            inducing: str = "replicated",
                            factorization: str | None = None):
    """The exact evidence over a (data, model) mesh, on every rank.
    ``X`` (n/D, d), ``y`` and ``mask`` are this rank's rows
    (``shard_batch(mesh, X, y)``); the kernel, ``z`` and ``sigma2`` are
    replicated.

    ``epilogue="distributed"`` keeps the Gram's column blocks sharded to
    the end: the distributed block Cholesky of I + G~ and a distributed
    forward substitution (with f64 rows the raw blocks are whitened in
    place by ``whiten_cols_replicated``).  ``inducing="distributed"`` also
    shards Km and its factor (module docstring), implies the distributed
    epilogue and takes any m (identity-padded to a multiple of M);
    ``factorization`` "raw" (the default with f64 rows) factors B = Km + G
    directly, "whitened" (the default in f32) I + U^-T G U^-1.  The
    replicated-inducing modes need M to divide m."""
    if mask is None:
        mask = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    n_model = mesh.model.size
    m = z.shape[0]
    if inducing == "distributed":
        # the linear algebra is identity-padded to a block multiple: the
        # virtual dimensions decouple exactly (zero cross-columns, unit
        # diagonal), so evidence and gradients are unchanged
        m_pad = -(-m // n_model) * n_model
        return _fully_distributed_evidence(
            kernel, mesh, _pad_inducing_rows(z, m_pad - m), sigma2, X, y,
            mask, variational=variational, block_size=block_size,
            jitter=jitter, m_real=m, factorization=factorization)
    if m % n_model != 0:
        raise ValueError(
            f"m ({m}) must be divisible by the model axis ({n_model}) "
            "for the replicated-inducing modes (inducing='distributed' "
            "pads automatically)")
    m_t = m // n_model
    j0 = mesh.j * m_t
    # raw-Gram tensor parallelism needs f64 accumulators to survive the
    # whitening sandwich; the f32 modes accumulate the whitened Gram
    raw_gram = z.dtype == torch.float64
    ind = calc_inducing(kernel, z, jitter)
    u_inv = inv_tri_upper(ind.chol_km)  # replicated (m, m)
    u_inv_j = u_inv[:, j0:j0 + m_t]

    def body(x_b, y_b, mask_b):
        knm = kernel.k_cross(x_b, z)  # (bs, m), duplicated over model
        kd = kernel.k_diag(x_b)
        live = mask_b > 0
        if raw_gram:
            v_j = matmul(knm, u_inv_j)  # (bs, m_t): the model-sharded GEMM
            r = kd - mesh.model.allsum(rows_sqr_norm(v_j))
            s = torch.where(live, r + sigma2, 1.0)
            is_ = mask_b / s
            # raw Gram column block, whitened in the epilogue
            gram = matmul(knm.T, is_[:, None] * knm[:, j0:j0 + m_t])
            u_vec = matmul(knm.T, is_ * y_b)
        else:
            # the full V a rank (duplicated GEMM), only the whitened
            # Gram's GEMM sharded: positive definite by construction
            v = matmul(knm, u_inv)
            r = kd - rows_sqr_norm(v)
            s = torch.where(live, r + sigma2, 1.0)
            is_ = mask_b / s
            sqrt_is = torch.where(
                live, torch.sqrt(torch.where(live, is_, 1.0)), 0.0)
            a = v * sqrt_is[:, None]
            gram = matmul(a.T, a[:, j0:j0 + m_t])
            u_vec = matmul(v.T, is_ * y_b)
        return gram, u_vec, _scalars(live, s, is_, y_b, r, mask_b)

    # the scalars and u were computed alike on every model member, so
    # like the Gram's column blocks they reduce over data only
    gram_j, u_vec, scal = allsum_many(mesh.data, _scan(body, X, y, mask,
                                                       block_size))
    if raw_gram:
        u_white = solve_tri(ind.chol_km, u_vec, trans=True)
    else:
        u_white = u_vec  # accumulated as V'(is y) = U^-T u
    if epilogue == "distributed":
        gw_j = (whiten_cols_replicated(ind.chol_km, gram_j, mesh.model)
                if raw_gram else gram_j)
        r_j = dist_cholesky_upper(
            _eye_cols(mesh.model, m, m_t, gw_j) + gw_j, mesh.model)
        t = dist_solve_lower_t(r_j, u_white, mesh.model)
        return _evidence(dist_log_det_tri(r_j, mesh.model), scal, t,
                         variational)
    gram = mesh.model.all_gather(gram_j, dim=1)  # (m, m)
    if raw_gram:
        g_white = matmul(u_inv.T, matmul(gram, u_inv))
        g_white = 0.5 * (g_white + g_white.T)
    else:
        g_white = gram  # already whitened in the blocks
    eye = torch.eye(m, dtype=gram.dtype, device=gram.device)
    r_tilde = cholesky_upper(eye + g_white, jitter=0.0)
    t = solve_tri(r_tilde, u_white, trans=True)
    return _evidence(log_det_tri(r_tilde), scal, t, variational)


def _pad_inducing_rows(z, pad: int):
    """``z`` with ``pad`` kernel-evaluable dummy rows (copies of row 0)
    appended; their matrix entries are masked to the identity."""
    if pad == 0:
        return z
    return torch.cat([z, z[:1].expand((pad,) + z.shape[1:])])


def _distributed_inducing(kernel, mesh: Mesh2D, z, m_real: int, jitter):
    """(km_j, u_j, p_j, col_live) of the fully distributed inducing
    state: this rank's column block of the jittered, identity-padded Km,
    of its upper Cholesky factor U and of Km^-1, and the mask of the real
    columns."""
    m = z.shape[0]
    m_t = m // mesh.model.size
    j0 = mesh.j * m_t
    dt = z.dtype
    km_j = k_upper_cols(kernel, z, j0, m_t)
    rows = torch.arange(m, device=z.device)[:, None]
    cols = j0 + torch.arange(m_t, device=z.device)[None, :]
    on_diag = rows == cols
    # identity-pad the virtual dimensions m_real..m: unit diagonal, zero
    # couplings, which add exactly nothing to the evidence
    km_j = torch.where((rows < m_real) & (cols < m_real), km_j,
                       on_diag.to(dt))
    real_diag = on_diag & (rows < m_real)
    jit = jitter if jitter is not None else config.cholesky_jitter
    jit_eff = torch.tensor(jit, dtype=dt, device=z.device)
    if jitter is None and dt == torch.float32:
        # numerics.linalg.cholesky_upper's policy: in f32 the default
        # jitter scales with the diagonal's magnitude
        diag_mean = mesh.model.allsum(torch.sum(
            torch.where(real_diag, torch.abs(km_j), 0.0))) / m_real
        jit_eff = torch.clamp(1e-5 * diag_mean, min=jit)
    km_j = km_j + torch.where(real_diag, jit_eff, 0.0)
    u_j = dist_cholesky_upper(km_j, mesh.model)
    p_j = dist_spd_inverse_cols(u_j, mesh.model)  # Km^-1 columns
    col_live = (torch.arange(m, device=z.device) < m_real)[None, :]
    return km_j, u_j, p_j, col_live


def _fully_distributed_evidence(kernel, mesh: Mesh2D, z, sigma2, X, y,
                                mask, *, variational, block_size, jitter,
                                m_real, factorization=None):
    """The evidence with no replicated m x m state
    (``inducing="distributed"``, ``sharded_log_evidence_2d``)."""
    if factorization is None:
        factorization = "raw" if z.dtype == torch.float64 else "whitened"
    if factorization not in ("raw", "whitened"):
        raise ValueError(f"unknown factorization {factorization!r}")
    m = z.shape[0]
    m_t = m // mesh.model.size
    j0 = mesh.j * m_t
    km_j, u_j, p_j, col_live = _distributed_inducing(kernel, mesh, z,
                                                     m_real, jitter)

    def body(x_b, y_b, mask_b):
        knm = torch.where(col_live, kernel.k_cross(x_b, z), 0.0)
        kd = kernel.k_diag(x_b)
        knm_j = knm[:, j0:j0 + m_t]
        # rowsq(V) = rowdot(Knm, Knm Km^-1): the model-sharded GEMM
        rq = mesh.model.allsum(torch.sum(knm_j * matmul(knm, p_j), dim=-1))
        live = mask_b > 0
        r = kd - rq
        s = torch.where(live, r + sigma2, 1.0)
        is_ = mask_b / s
        return (matmul(knm.T, is_[:, None] * knm_j),
                matmul(knm.T, is_ * y_b),
                _scalars(live, s, is_, y_b, r, mask_b))

    # in f32, two-sum pairs: the cross-block rounding of the raw Gram is
    # what the whitening downstream amplifies
    gram_j, u_vec, scal = allsum_many(mesh.data, _scan(
        body, X, y, mask, block_size, comp=z.dtype == torch.float32))
    if factorization == "raw":
        # R'R = B = Km~ + G, fully distributed
        r_j = dist_cholesky_upper(km_j + gram_j, mesh.model)
        log_det_ratio = (dist_log_det_tri(r_j, mesh.model)
                         - dist_log_det_tri(u_j, mesh.model))
        t = dist_solve_lower_t(r_j, u_vec, mesh.model)
    else:
        # G~ = U^-T G U^-1 by the distributed two-sided whitening; the
        # identity margin of I + G~ absorbs f32 rounding
        gw_j = dist_whiten_cols(u_j, gram_j, mesh.model)
        rt_j = dist_cholesky_upper(
            _eye_cols(mesh.model, m, m_t, gw_j) + gw_j, mesh.model)
        log_det_ratio = dist_log_det_tri(rt_j, mesh.model)
        # R = R~ U: R't = u  =>  U'w = u, then R~'t = w
        w = dist_solve_lower_t(u_j, u_vec, mesh.model)
        t = dist_solve_lower_t(rt_j, w, mesh.model)
    return _evidence(log_det_ratio, scal, t, variational)


def _shard_rows(mesh: Mesh2D, X, y, mask):
    """This data member's rows of the whole (X, y), padded to a multiple
    of D, and their mask (times ``mask`` where given)."""
    Xp, yp, mp = pad_to_shards(mesh, X, y)
    if mask is not None:
        mp = mp * torch.cat([mask.to(mp), mp.new_zeros(
            mp.shape[0] - mask.shape[0])])
    return tuple(local_rows(mesh, t) for t in (Xp, yp, mp))


@torch.no_grad()
def fully_distributed_predict(kernel, mesh: Mesh2D, z, sigma2, X, y, Xstar,
                              mask=None, *, variational: bool = False,
                              block_size: int = 8192,
                              jitter: float | None = None,
                              predictive: bool = True):
    """Posterior means and variances at ``Xstar`` with no replicated m x m
    state: the serving side of ``inducing="distributed"``.  Conditions on
    the whole (X, y) (``mask`` over its rows; ``variational`` is accepted
    as the JAX package's is and, as there, changes nothing) through the
    fully distributed statistics, then

        mean = Ktm coeffs                         (coeffs replicated)
        var  = kt_diag - rowdot(Ktm, Ktm Km^-1) + rowdot(Ktm, Ktm B^-1)

    the two inverses as column blocks, the rowdots summed over the model
    axis, ``Xstar``'s rows split over the data axis.  Returns (means,
    variances) in ``Xstar``'s row order on every rank."""
    m_real = z.shape[0]
    n_model = mesh.model.size
    m = -(-m_real // n_model) * n_model
    z = _pad_inducing_rows(z, m - m_real)
    m_t = m // n_model
    j0 = mesh.j * m_t
    km_j, _, p_j, col_live = _distributed_inducing(kernel, mesh, z, m_real,
                                                   jitter)

    def body(x_b, y_b, mask_b):
        knm = torch.where(col_live, kernel.k_cross(x_b, z), 0.0)
        knm_j = knm[:, j0:j0 + m_t]
        rq = mesh.model.allsum(torch.sum(knm_j * matmul(knm, p_j), dim=-1))
        live = mask_b > 0
        s = torch.where(live, kernel.k_diag(x_b) - rq + sigma2, 1.0)
        is_ = mask_b / s
        return (matmul(knm.T, is_[:, None] * knm_j),
                matmul(knm.T, is_ * y_b))

    gram_j, u_vec = allsum_many(mesh.data, _scan(
        body, *_shard_rows(mesh, X, y, mask), block_size))
    r_j = dist_cholesky_upper(km_j + gram_j, mesh.model)
    binv_j = dist_spd_inverse_cols(r_j, mesh.model)
    t = dist_solve_lower_t(r_j, u_vec, mesh.model)
    # coeffs = B^-1 u: the upper solve on the m-vector
    coeffs = dist_solve_upper_cols(r_j, t[:, None], mesh.model)[:, 0]

    xs = _local_padded(mesh, Xstar)
    bs = min(block_size, xs.shape[0])
    mus, variances = [], []
    for start in range(0, xs.shape[0], bs):
        x_b = xs[start:start + bs]
        ktm = torch.where(col_live, kernel.k_cross(x_b, z), 0.0)
        ktm_j = ktm[:, j0:j0 + m_t]
        rq_prior, rq_post = mesh.model.allsum(torch.stack([
            torch.sum(ktm_j * matmul(ktm, p_j), dim=-1),
            torch.sum(ktm_j * matmul(ktm, binv_j), dim=-1)])).unbind()
        var = kernel.k_diag(x_b) - rq_prior + rq_post
        mus.append(matmul(ktm, coeffs))
        variances.append(var + sigma2 if predictive else var)
    n_star = Xstar.shape[0]
    return (gather_rows(mesh.data, torch.cat(mus), n_star),
            gather_rows(mesh.data, torch.cat(variances), n_star))


def _neg_evidence_2d(mesh, pack, scale, log_prior, **kw):
    """x, X, y, mask -> the scaled negative 2-D evidence (+ prior)."""

    def f(x, X, y, mask):
        kernel, z, sigma2 = pack.unpack(x)
        l = sharded_log_evidence_2d(kernel, mesh, z, sigma2, X, y, mask,
                                    **kw)
        if log_prior is not None:
            l = l + log_prior(kernel, z, sigma2)
        return -l * scale

    return f


def fit_sharded_2d(mesh: Mesh2D, X, y, pack, *, variational: bool = False,
                   block_size: int = 8192, normalize: bool = True,
                   step: float = 0.1, tol: float = 0.1, epsabs: float = 0.1,
                   max_iter: int = 100, history: int = 10,
                   f_noise: float | None = None, dispatch_iters: int = 50,
                   log_prior=None, epilogue: str = "replicated",
                   inducing: str = "replicated",
                   factorization: str | None = None, init_state=None,
                   state_callback=None):
    """Training over the 2-D mesh: the chunked device L-BFGS
    (``optim.fit_packed_objective``) with the tensor-parallel evidence as
    its objective, on every rank in lock step; ``X`` and ``y`` are the
    whole data (each rank keeps its data member's rows).  Semantics are
    ``fit_sharded``'s and ``sharded_log_evidence_2d``'s; returns (kernel,
    z, sigma2, LBFGSDeviceState), the same on every rank."""
    from ..optim.lbfgs_device import fit_packed_objective

    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == torch.float32 else 0.0
    f = _neg_evidence_2d(mesh, pack, scale, log_prior,
                         variational=variational, block_size=block_size,
                         epilogue=epilogue, inducing=inducing,
                         factorization=factorization)
    st = fit_packed_objective(
        functools.partial(sharded_value_and_grad, mesh, f), pack,
        shard_batch(mesh, X, y), step=step, tol=tol, epsabs=epsabs,
        max_iter=max_iter, history=history, f_noise=f_noise,
        dispatch_iters=dispatch_iters, init_state=init_state,
        state_callback=state_callback)
    kernel, z, sigma2 = pack.unpack(st.x)
    return kernel, z, sigma2, st
