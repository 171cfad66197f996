"""Evidence-maximization training: the counterpart of
``gpr_tpu/optim/train.py`` (the reference's ``Optim.Gsl.train``,
lib/fitc_gp.ml:1465-1671).

:func:`train` has the JAX package's keyword surface and defaults: sigma2
defaults to the target second moment, the inducing count to min(n/10,
1000) with random selection; best-model-so-far tracking, callbacks and
interrupt-by-exception behave like the reference (:class:`Bailout` from a
callback returns the best trained model seen), and ``checkpoint_path`` /
``resume`` continue an interrupted run exactly.  Where the JAX package
takes ``(family, params)`` and a ``key``, this takes the kernel class, a
kernel module (``kernel_params``) and a ``torch.Generator``.

:func:`make_objective` is the packed objective that ``train``, the f64
polish (``optim/polish.py``) and ``fit_restarts``' rescoring drive: the
negative log evidence, dense or streaming, over the packed hyper vector.
:func:`train_sgd` and :func:`train_smd` ascend the dense evidence.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from ..models.fitc import calc_model, calc_trained, choose_n_random_inputs
from ..models.streaming import streaming_log_evidence, streaming_trained
from .lbfgs import minimize_lbfgs
from .pack import make_pack
from .sgd_smd import run_ascent, sgd_create, sgd_step, smd_create, smd_step


class Bailout(Exception):
    """Raise from a callback to stop training and keep the best model
    (bin/ocaml_gpr.ml:380 ``exception Bailout``)."""


class TrainResult:
    """Trained state plus the optimized hyperparameters.

    Attribute access falls through to the wrapped trained state (``.l``,
    ``.coeffs``, ``.model`` ...), so it serves wherever a trained state is
    expected, while ``kernel_params`` (a kernel module), ``inducing`` and
    ``sigma2`` give what the reference's ``Trained.get_model`` +
    ``Model.get_kernel`` chain gives (bin/ocaml_gpr.ml:205-212).
    """

    def __init__(self, trained, kernel_params, inducing, sigma2):
        self.trained = trained
        self.kernel_params = kernel_params
        self.inducing = inducing
        self.sigma2 = sigma2

    def __getattr__(self, name):
        if name == "trained":  # not yet set (copy, unpickling)
            raise AttributeError(name)
        return getattr(self.trained, name)


def default_sigma2(targets) -> float:
    """sigma2 default = uncentered target variance (fitc_gp.ml:1468-1472)."""
    y = torch.as_tensor(targets).detach().to(torch.float64)
    return float(torch.dot(y, y) / y.shape[0])


def default_n_inducing(n_inputs: int) -> int:
    """min(n/10, 1000) (fitc_gp.ml:1477-1479)."""
    return max(1, min(n_inputs // 10, 1000))


def _prepare(family, X, targets, kernel_params, sigma2, inducing,
             n_rand_inducing, generator):
    n = X.shape[0]
    if sigma2 is None:
        sigma2 = default_sigma2(targets)
    elif sigma2 < 0:
        raise ValueError(f"sigma2 < 0: {sigma2}")
    if inducing is None:
        m = (default_n_inducing(n) if n_rand_inducing is None
             else int(n_rand_inducing))
        if not 1 <= m <= n:
            raise ValueError(f"violating 1 <= n_inducing ({m}) <= n ({n})")
        if kernel_params is None:
            kernel_params = family.default_params(X, m, generator)
        inducing = choose_n_random_inputs(generator, kernel_params, X, m)
    elif kernel_params is None:
        kernel_params = family.default_params(X, inducing.shape[0], generator)
    return kernel_params, sigma2, inducing


def _objective(X, targets, pack, *, variational, factorization, block_size,
               log_prior, scale):
    """(neg_l, trained_of): the pure scaled negative objective of the
    packed vector (differentiable, by autograd or ``torch.func``) and the
    trained state at x."""

    def dense_trained(kernel, z, sigma2):
        model = calc_model(kernel, X, z, sigma2, variational=variational,
                           factorization=factorization)
        return calc_trained(model, targets)

    def neg_l(x):
        kernel, z, sigma2 = pack.unpack(x)
        if block_size is not None:
            l = streaming_log_evidence(kernel, z, sigma2, X, targets,
                                       variational=variational,
                                       block_size=block_size)
        else:
            l = dense_trained(kernel, z, sigma2).l
        if log_prior is not None:
            l = l + log_prior(kernel, z, sigma2)
        return -l * scale

    @torch.no_grad()
    def trained_of(x):
        kernel, z, sigma2 = pack.unpack(x)
        if block_size is not None:
            return streaming_trained(kernel, z, sigma2, X, targets,
                                     variational=variational,
                                     block_size=block_size)
        return dense_trained(kernel, z, sigma2)

    return neg_l, trained_of


def make_objective(X, targets, pack, *, variational=False,
                   factorization=None, normalize=False, block_size=None,
                   log_prior=None, value_only=False):
    """(value, grad) of the NEGATIVE evidence over the packed vector, plus a
    trained-state reconstruction for reporting: ``(fg, trained_of)`` with
    ``fg(x) -> (f, g)`` tensors on the data's device (f detached).

    The JAX ``make_objective(family, ...)`` minus ``family``: the pack's
    kernel class is it.  ``normalize=True`` optimizes the mean NLL (-l/n).
    ``block_size`` switches to the streaming evidence
    (``models/streaming.py``), which never materializes Knm; without it the
    dense engine (``models/fitc.py``) runs.  ``log_prior(kernel, z, sigma2)
    -> scalar`` makes it MAP estimation.  ``value_only=True`` makes the
    first return ``f(x) -> value`` with no backward pass.  (The JAX
    ``return_raw``, for embedding in a jitted graph, has no use here.)
    """
    neg_l, trained_of = _objective(
        X, targets, pack, variational=variational,
        factorization=factorization, block_size=block_size,
        log_prior=log_prior, scale=1.0 / X.shape[0] if normalize else 1.0)

    def neg_l_and_grad(x):
        if value_only:
            with torch.no_grad():
                return neg_l(x)
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = neg_l(x)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g

    return neg_l_and_grad, trained_of


def train(
    family,
    X,
    targets,
    *,
    kernel_params=None,
    sigma2: float | None = None,
    inducing=None,
    n_rand_inducing: int | None = None,
    learn_sigma2: bool = True,
    learn_inducing: bool | None = None,
    fixed: Sequence[str] = (),
    variational: bool = False,
    factorization: str | None = None,
    block_size: int | None = None,
    log_prior=None,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int | None = None,
    report_trained_model: Callable[..., None] | None = None,
    report_gradient_norm: Callable[..., None] | None = None,
    generator: torch.Generator | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
) -> TrainResult:
    """Host L-BFGS evidence maximization of the kernel class ``family``
    (e.g. ``SeIso``) on X's device; returns the best trained model seen,
    with its optimized kernel module, inducing points and noise level.

    ``kernel_params`` is a kernel module (default ``family.default_params``)
    and ``inducing`` a tensor of inducing inputs (default: ``n_rand_inducing``
    random rows of X, drawn with ``generator``, default
    ``torch.Generator(X.device).manual_seed(0)``).  The objective is the
    TOTAL negative evidence, as in the JAX package: at n ~ 10^6 in f32 its
    rounding (about 0.1 nats) can stop the line search early.  The host
    loop works in f64 numpy; each evaluation crosses to the device and back.

    Callbacks receive keyword arguments (``iter=..., trained=...`` /
    ``norm=...``) and may raise :class:`Bailout` (or KeyboardInterrupt) to
    stop with the best model so far; other exceptions propagate.  A NaN
    objective at the start raises FloatingPointError; at a line-search
    probe it reads as +inf with a zero gradient, so the search backs off.

    ``checkpoint_path`` persists the full optimizer state (packed hypers,
    curvature history, best so far) every ``checkpoint_every`` accepted
    iterations, in the JAX package's format; ``resume=True`` continues from
    that file (same data and model set-up) and reproduces the uninterrupted
    trajectory exactly.
    """
    if generator is None:
        generator = torch.Generator(X.device).manual_seed(0)
    kernel_params, sigma2, inducing = _prepare(
        family, X, targets, kernel_params, sigma2, inducing, n_rand_inducing,
        generator)
    pack = make_pack(kernel_params, inducing, sigma2,
                     learn_sigma2=learn_sigma2, learn_inducing=learn_inducing,
                     fixed=fixed)
    neg_l_and_grad, trained_of = make_objective(
        X, targets, pack, variational=variational,
        factorization=factorization, block_size=block_size,
        log_prior=log_prior)

    def on_device(x):
        return torch.as_tensor(x, dtype=pack.x0.dtype, device=pack.x0.device)

    init_state = None
    best: dict = {"le": -np.inf, "x": pack.x0.detach().cpu().numpy()}
    if resume:
        if checkpoint_path is None:
            raise ValueError("resume=True requires checkpoint_path")
        if os.path.exists(checkpoint_path):
            from ..io.resume import load_train_checkpoint

            init_state, best_x, best_le = load_train_checkpoint(
                checkpoint_path)
            if init_state.x.shape != tuple(pack.x0.shape):
                raise ValueError(
                    f"checkpoint hyper vector has shape {init_state.x.shape}"
                    f" but this configuration packs {tuple(pack.x0.shape)}"
                    " — resume requires the same model/data setup"
                )
            best = {"le": best_le, "x": best_x}
    n_evals = {"n": 0}

    def fg(x):
        f, g = neg_l_and_grad(on_device(x))
        f = float(f)
        g = g.detach().cpu().numpy().astype(np.float64)
        n_evals["n"] += 1
        if np.isnan(f):
            if n_evals["n"] == 1:
                # NaN at the starting point is unrecoverable
                # (fitc_gp.ml:1523-1528)
                raise FloatingPointError("optimization function returned nan")
            # NaN at a line-search probe (sigma2 underflow, exp overflow at
            # a wild trial step) just means "step too far"
            return np.inf, np.zeros_like(g)
        return f, g

    def callback(it, x, f, g):
        le = -f
        if le > best["le"]:
            best["le"] = le
            best["x"] = np.asarray(x)
            if report_trained_model is not None:
                report_trained_model(iter=it + 1,
                                     trained=trained_of(on_device(x)))
        if report_gradient_norm is not None:
            report_gradient_norm(iter=it + 1, norm=float(np.linalg.norm(g)))

    state_callback = None
    if checkpoint_path is not None:
        from ..io.resume import save_train_checkpoint

        def state_callback(st):
            if st.n_iter % max(1, checkpoint_every) == 0:
                save_train_checkpoint(checkpoint_path, st, best_x=best["x"],
                                      best_le=best["le"])

    try:
        minimize_lbfgs(
            fg, pack.x0.detach().cpu().numpy().astype(np.float64),
            step=step, tol=tol, epsabs=epsabs, max_iter=max_iter,
            callback=callback, init_state=init_state,
            state_callback=state_callback,
        )
    except (Bailout, KeyboardInterrupt):
        pass  # return the best model so far (bin/ocaml_gpr.ml:337-345)

    x_best = on_device(best["x"])
    kernel_b, z_b, sigma2_b = pack.unpack(x_best)
    return TrainResult(trained_of(x_best), kernel_b, z_b, sigma2_b)


def _ascent_setup(family, X, targets, kernel_params, sigma2, inducing,
                  n_rand_inducing, learn_sigma2, learn_inducing, fixed,
                  variational, factorization, generator):
    """(pack, grad_fn, value_fn, trained_of) of the dense evidence: the
    ascent gradient is ``torch.func.grad`` of the pure objective, so that
    SMD's ``torch.func.vjp`` of it is the exact Hessian-vector product."""
    if generator is None:
        generator = torch.Generator(X.device).manual_seed(0)
    kernel_params, sigma2, inducing = _prepare(
        family, X, targets, kernel_params, sigma2, inducing, n_rand_inducing,
        generator)
    pack = make_pack(kernel_params, inducing, sigma2,
                     learn_sigma2=learn_sigma2, learn_inducing=learn_inducing,
                     fixed=fixed)
    neg_l, trained_of = _objective(
        X, targets, pack, variational=variational,
        factorization=factorization, block_size=None, log_prior=None,
        scale=1.0)
    neg_grad = torch.func.grad(neg_l)

    def grad_fn(x):
        return -neg_grad(x)  # ascent gradient

    @torch.no_grad()
    def value_fn(x):
        return -float(neg_l(x))

    return pack, grad_fn, value_fn, trained_of


_ASCENT_KEYS = ("kernel_params", "sigma2", "inducing", "n_rand_inducing",
                "learn_sigma2", "learn_inducing", "fixed", "variational",
                "factorization", "generator")
_ASCENT_DEFAULTS = (None, None, None, None, True, None, (), False, None, None)


def _ascent(family, X, targets, kw, create, step_fn, epsabs, max_iter,
            report) -> TrainResult:
    """The body of train_sgd and train_smd: set up, ascend, report the
    best state."""
    args = [kw.pop(k, d) for k, d in zip(_ASCENT_KEYS, _ASCENT_DEFAULTS)]
    if kw:
        raise TypeError(f"unexpected keyword arguments: {sorted(kw)}")
    pack, grad_fn, value_fn, trained_of = _ascent_setup(family, X, targets,
                                                        *args)
    best = run_ascent(lambda s: step_fn(grad_fn, s), value_fn,
                      create(grad_fn, pack.x0), epsabs=epsabs,
                      max_iter=max_iter, report=report)
    kernel_b, z_b, sigma2_b = pack.unpack(best.x)
    return TrainResult(trained_of(best.x), kernel_b, z_b, sigma2_b)


def train_sgd(family, X, targets, *, tau=100.0, eta0=1e-3, epsabs=0.1,
              max_iter=None, report=None, **kw) -> TrainResult:
    """SGD evidence ascent (fitc_gp.ml:1724-1833) on the dense engine;
    ``kw`` takes :func:`train`'s model keywords (``kernel_params``,
    ``sigma2``, ``inducing``, ``n_rand_inducing``, ``learn_sigma2``,
    ``learn_inducing``, ``fixed``, ``variational``, ``factorization``,
    ``generator``)."""
    return _ascent(family, X, targets, kw,
                   lambda g, x0: sgd_create(g, x0, tau=tau, eta0=eta0),
                   sgd_step, epsabs, max_iter, report)


def train_smd(family, X, targets, *, lambda_=0.1, mu=1e-3, eta0=1e-3,
              nu0=1e-3, epsabs=0.1, max_iter=None, report=None,
              **kw) -> TrainResult:
    """SMD evidence ascent with exact Hessian-vector products
    (fitc_gp.ml:1835-2019) on the dense engine; ``kw`` as
    :func:`train_sgd`."""
    return _ascent(family, X, targets, kw,
                   lambda g, x0: smd_create(g, x0, lambda_=lambda_, mu=mu,
                                            eta0=eta0, nu0=nu0),
                   smd_step, epsabs, max_iter, report)
