"""Command-line trainer/predictor — the rebuild of bin/ocaml_gpr.ml.

The counterpart of ``gpr_tpu/cli.py`` in PyTorch: the same flags, the same
CSV-over-stdin protocol and the same text on stdout and stderr, for the
regression path.  Training is the variational FIC with the se_fat kernel
by default (bin/ocaml_gpr.ml:176-177; ``-kernel NAME`` takes any other base
family or a structural name such as ``sum(se_iso,lin_ard)``, with its
default hyper init and ``-amplitude`` on its signal variance where it has a
top-level one; ``-kernel smQ`` is the Q-component spectral mixture
initialized from the data's spectrum; ``-tasks T -coreg-rank R`` the ICM
multi-output model over a trailing task-id column, whose learned B
``-verbose`` prints): target centering and the reference's per-dimension input
standardization (:249-269), L-BFGS evidence maximization with 1 Hz
throttled verbose reports and a SIGINT-safe best-model bailout (:301-349),
the host trainer or ``-trainer device`` (with ``-restarts``, ``-polish``,
the sparse ``-loo`` and ``-checkpoint``/``-resume``), the Gaussian-likelihood
extensions with ``-trainer device`` (``-student-t NU``, ``-warp K``,
``-pitc-block B``), the exact dense GP (``-exact``, with ``-loo``), the
iterative exact GP (``-exact -cg``: SGD on stochastic exact-evidence
gradients, then one preconditioned CG solve; ``models/iterative.py``), and
the npz artifact of ``io/checkpoint.py``, which either package loads.
``-cmd test`` prints the means (and ``-with-stddev`` the standard
deviations) of a regression artifact: a warped one's integrate the inverse
warp, an exact one's come from the dense posterior, an ``exact_cg`` one's
from CG solves against its stored training inputs.

Everything runs in f64, as the reference's LAPACK does, on the card
(``cuda``) unless ``GPR_TPU_PLATFORM=cpu`` asks for the CPU; with no GPU
and no such request the program exits rather than fall back.  The random
draws of a restart come from ``np.random.default_rng(seed + r)`` (the
projection, bit-equal to the JAX package's) and from a
``torch.Generator`` seeded with ``seed + r`` (random or k-means inducing
rows) or with the integer that seeds the JAX package's key (cosine's
default frequencies): these draws differ from the JAX package's.

The Laplace likelihoods (``-classify`` with binary labels, ``-poisson``,
``-binomial``, ``-negbin R0``, ``-ordinal``), binary EP (``-classify
-approx ep``) and the softmax Laplace (``-classify`` with integer labels
0..C-1, C >= 3) train with ``-trainer device`` and write the regression
artifact's schema with the mode's extras (the multi-class model's m-space
state in ``mc_a_tilde``/``mc_b_tilde``); ``-cmd test`` serves their
probabilities, rates or counts.  ``-trainer sharded -devices N`` trains
on N spawned ranks of a ``torch.distributed`` world (``parallel.run_spmd``:
one card each where there are N cards, else gloo ranks sharing the card,
or gloo CPU ranks under ``GPR_TPU_PLATFORM=cpu``; default N: every visible
card, 1 on the CPU): each rank runs this command's preparation on the
parsed rows and fits its share of them with the mesh, and this process
writes the artifact from rank 0's hypers, on the whole data, as the
single-device trainers do; SIGINT stops every rank after the same chunk
and keeps that state, as ``-trainer device`` does.  ``-devices DxM``
trains on a 2-D (data x model) mesh of D M ranks
(``parallel.mesh2d.fit_sharded_2d``, or ``fit_restarts_sharded`` with
-restarts), the regression model only, as in the JAX package.  The CG
path's probes and anchor rows come from a ``torch.Generator``
seeded with ``-seed`` (serving: seeded 0), not from JAX's keys.

Run: ``python3 -m gpr_tpu_torch.cli -cmd train -model m.npz < train.csv``,
then ``python3 -m gpr_tpu_torch.cli -cmd test -model m.npz < test.csv``.
"""

from __future__ import annotations

import argparse
import copy
import math
import os
import signal
import sys
import time
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

F64 = torch.float64


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpr_tpu", description=__doc__.splitlines()[0]
    )
    p.add_argument("-cmd", choices=["train", "test"], default="train",
                   help="train (default) or test model")
    p.add_argument("-model", required=True, help="model file to use")
    p.add_argument("-with-stddev", dest="with_stddev", action="store_true",
                   help="make predictions with both mean and standard deviation")
    p.add_argument("-predictive", action="store_true",
                   help="standard deviation includes noise level (predictive)")
    p.add_argument("-max-iter", dest="max_iter", type=int, default=None,
                   help="maximum number of optimization steps (default: limitless)")
    p.add_argument("-n-inducing", dest="n_inducing", type=int, default=10,
                   help="number of randomly initialized inducing inputs (default: 10)")
    p.add_argument("-sigma2", type=float, default=1.0,
                   help="initial noise level (default: 1.0)")
    p.add_argument("-amplitude", type=float, default=1.0,
                   help="initial amplitude level (default: 1.0)")
    p.add_argument("-kernel", default="se_fat",
                   help="covariance family: se_fat (default, the "
                        "reference CLI's choice), se_iso, se_ard, "
                        "matern32, matern52, rq, periodic, cosine, "
                        "lin_one, lin_ard, const, or a combinator like "
                        "'sum(se_iso,lin_ard)' / 'prod(periodic,se_iso)' "
                        "/ 'sum(prod(se_ard,cosine),...)' (nested ok), or "
                        "smQ (e.g. sm3): a Q-component spectral mixture "
                        "initialized from the data's empirical spectrum "
                        "(kernels/sm_init.py; restarts draw power-weighted "
                        "frequencies).  Non-se_fat families use their "
                        "default hyper init (-amplitude still sets the "
                        "signal variance where the family has one); "
                        "-dim-red/-log-het-sked/-multiscale are "
                        "se_fat-only")
    p.add_argument("-inducing-init", dest="inducing_init",
                   choices=["random", "kmeans", "first"], default="random",
                   help="inducing-point initialization: random subset "
                        "(the reference's behavior), k-means centroids "
                        "(better input-density coverage when m << n and "
                        "the data clusters; models.fitc."
                        "choose_kmeans_inputs), or the first n rows.  "
                        "kmeans is rejected with -tasks (centroids "
                        "would average the integer task ids)")
    p.add_argument("-tasks", type=int, default=None, metavar="T",
                   help="multi-output (ICM) modelling: the LAST input "
                        "column is an integer task id 0..T-1 and the "
                        "kernel becomes B[t,t'] * k(features) with a "
                        "LEARNED T x T coregionalization "
                        "B = WW' + diag (kernels/task.py; rank of W "
                        "from -coreg-rank).  The task column is "
                        "excluded from input standardization.  "
                        "Composes with any -kernel and with the "
                        "likelihood flags")
    p.add_argument("-coreg-rank", dest="coreg_rank", type=int, default=1,
                   metavar="R",
                   help="rank of the shared coregionalization factor W "
                        "(default 1; R = T allows any PSD B)")
    p.add_argument("-dim-red", dest="dim_red", type=int, default=None,
                   help="dimensionality reduction (default: none)")
    p.add_argument("-log-het-sked", dest="log_het_sked", type=float,
                   default=None,
                   help="turns on / sets log-heteroskedastic noise")
    p.add_argument("-multiscale", action="store_true",
                   help="turns on multiscale approximation")
    p.add_argument("-tol", type=float, default=0.1,
                   help="tolerance for gradient descent (default: 0.1)")
    p.add_argument("-step", type=float, default=0.1,
                   help="step size for gradient descent (default: 0.1)")
    p.add_argument("-eps", type=float, default=0.1,
                   help="epsilon for gradient descent (default: 0.1)")
    p.add_argument("-block-size", dest="block_size", type=int, default=None,
                   help="train with the streaming evidence in row blocks of "
                        "this size: memory stays O(block x m) at any n "
                        "(default: dense n x m cross-covariance)")
    p.add_argument("-trainer", choices=["host", "device", "sharded"],
                   default="host",
                   help="host (default): callback-rich host L-BFGS loop; "
                        "device: device-resident chunked L-BFGS "
                        "(optim.lbfgs_device.fit — production throughput, "
                        "mean-NLL objective so -eps applies per point); "
                        "sharded: multi-chip data-parallel training over "
                        "a device mesh (parallel.fit_sharded)")
    p.add_argument("-devices", default=None,
                   help="mesh for -trainer sharded: N (1-D data-parallel "
                        "mesh) or DxM (2-D data x model mesh — tensor "
                        "parallelism over the inducing axis, "
                        "parallel.fit_sharded_2d; M must divide "
                        "-n-inducing).  Default: all visible devices, 1-D")
    p.add_argument("-exact", action="store_true",
                   help="train an EXACT dense GP instead of the sparse "
                        "approximation (models/exact.py): no inducing "
                        "points, O(n^3) chol — for small n (capped at "
                        "20000 rows) and as the gold standard the sparse "
                        "paths approach.  -n-inducing and the inducing/"
                        "streaming/mesh flags do not apply")
    p.add_argument("-cg", action="store_true",
                   help="with -exact: ITERATIVE exact GP "
                        "(models/iterative.py) — K is never materialized "
                        "(blocked MXU matvecs) and the solves run "
                        "Nystrom/FITC-preconditioned CG, lifting the dense "
                        "20000-row cap.  Hypers train by SGD on unbiased "
                        "stochastic exact-evidence gradients "
                        "(evidence_grads_iter); -n-inducing sets the "
                        "preconditioner anchor count, -max-iter the SGD "
                        "steps.  -cmd test serves exact CG variances with "
                        "-with-stddev.")
    p.add_argument("-loo", action="store_true",
                   help="optimize the leave-one-out predictive "
                        "pseudo-likelihood instead of the evidence (GPML "
                        "sec. 5.4.2 — more robust to model "
                        "misspecification).  With -exact: dense closed "
                        "form (one triangular inverse per step).  Without: "
                        "the sparse FITC LOO (models/loo.py, O(nm) on top "
                        "of the evidence pieces) — requires -trainer "
                        "device, no -block-size")
    p.add_argument("-pitc-block", dest="pitc_block", type=int, default=None,
                   metavar="B",
                   help="train with the PITC evidence instead of FITC: the "
                        "exact covariance is kept within blocks of B "
                        "training rows (an accuracy dial between FITC and "
                        "the exact GP; models/pitc.py).  Requires -trainer "
                        "device|sharded")
    p.add_argument("-warp", type=int, default=0, metavar="K",
                   help="warped GP: learn a K-term monotone tanh-sum "
                        "observation warp jointly with the hypers "
                        "(models/warped.py; for skewed/heavy-tailed "
                        "targets).  Test-time means/stddevs integrate the "
                        "inverse warp by quadrature.  Requires -trainer "
                        "device|sharded")
    p.add_argument("-classify", action="store_true",
                   help="GP classification (Laplace over the FITC prior): "
                        "0/1 or -1/+1 targets select the binary classifier "
                        "(models/classify.py; test output is the class "
                        "probability, with -with-stddev: "
                        "prob,latent-stddev); integer targets 0..C-1 "
                        "select the C-class softmax Laplace "
                        "(models/classify_multi.py; test output is one "
                        "probability per class).  Requires -trainer "
                        "device|sharded")
    p.add_argument("-poisson", action="store_true",
                   help="Poisson count regression (Laplace with exp link "
                        "over the FITC prior, models/poisson.py): targets "
                        "must be nonnegative counts; test output is the "
                        "posterior rate mean (with -with-stddev: "
                        "rate,rate-stddev; unit exposure — use the library "
                        "API for exposure offsets).  Requires -trainer "
                        "device|sharded")
    p.add_argument("-binomial", action="store_true",
                   help="binomial proportion regression (logit Laplace, "
                        "models/binomial.py): the training CSV's last TWO "
                        "columns are trials,successes (so x...,N,y; at "
                        "N = 1 this is the binary classifier).  Test rows "
                        "carry only the x columns; output is the success "
                        "probability per row (with -with-stddev: "
                        "prob,latent-stddev) — multiply by N* for expected "
                        "successes.  Requires -trainer device|sharded")
    p.add_argument("-negbin", dest="negbin", type=float, default=None,
                   metavar="R0",
                   help="negative-binomial (overdispersed count) regression "
                        "(NB2-Laplace with exp link, models/negbin.py): "
                        "targets must be nonnegative counts; the dispersion "
                        "r starts at R0 (> 0) and is LEARNED by evidence "
                        "ascent (reported on stderr and stored in the "
                        "model file; r -> inf recovers -poisson).  Test "
                        "output is the posterior count mean per unit "
                        "exposure (with -with-stddev: mean,count-stddev "
                        "via the law of total variance).  Requires "
                        "-trainer device|sharded")
    p.add_argument("-ordinal", action="store_true",
                   help="ordinal regression (cumulative probit Laplace "
                        "with learnable cutpoints, models/ordinal.py): "
                        "targets must be ordered integer categories "
                        "0..K-1; test output is one probability per "
                        "category (with -with-stddev: plus the latent "
                        "stddev).  Requires -trainer device|sharded")
    p.add_argument("-student-t", dest="student_t", type=float, default=None,
                   metavar="NU",
                   help="robust regression with Student-t noise of NU "
                        "degrees of freedom (NU > 2; variational EM over "
                        "the scale mixture, models/robust.py): outlier "
                        "rows are downweighted automatically; test output "
                        "is the usual mean (with -with-stddev: the "
                        "moment-matched predictive stddev).  Requires "
                        "-trainer device|sharded")
    p.add_argument("-approx", choices=["laplace", "ep"], default="laplace",
                   help="Gaussian approximation for -classify (binary): "
                        "laplace (default; logit likelihood, MacKay probit "
                        "squash) or ep (expectation propagation, probit "
                        "likelihood, exact predictive — "
                        "models/classify_ep.py)")
    p.add_argument("-polish", type=int, default=0, metavar="N",
                   help="f64 finishing step after training: re-optimize the "
                        "hypers on a host-CPU f64 objective over N "
                        "subsampled rows (0 = off; restores the reference's "
                        "f64 convergence semantics after an f32 device run)")
    p.add_argument("-restarts", type=int, default=1,
                   help="random restarts: retrain from fresh random "
                        "inducing/projection draws (seed+r) and keep the "
                        "best final log evidence — the hyper landscape is "
                        "multi-modal (docs/MANUAL.md section 7)")
    p.add_argument("-checkpoint", default=None,
                   help="persist optimizer state to this file every "
                        "accepted iteration (enables -resume)")
    p.add_argument("-resume", action="store_true",
                   help="continue an interrupted -checkpoint run (requires "
                        "the same data and flags; reproduces the "
                        "uninterrupted trajectory)")
    p.add_argument("-verbose", action="store_true",
                   help="prints information while training")
    p.add_argument("-seed", type=int, default=None,
                   help="RNG seed (default: nondeterministic, like the "
                        "reference's Random.self_init)")
    return p


def _sm_q(kernel: str) -> int | None:
    """Q for the '-kernel smQ' spectral-mixture shorthand, else None."""
    import re

    m = re.fullmatch(r"sm([0-9]+)", kernel)
    if m is None:
        return None
    q = int(m.group(1))
    if q < 1:
        raise SystemExit("-kernel smQ needs Q >= 1")
    return q


def _family(args):
    """The selected kernel family (CLI -kernel; default se_fat, the
    reference CLI's hardwired choice, bin/ocaml_gpr.ml:176-177)."""
    from .kernels import resolve_family, sm_family

    q = _sm_q(args.kernel)
    if q is not None:
        return sm_family(q)
    return resolve_family(args.kernel)


def _device() -> torch.device:
    """The card, or the CPU where ``GPR_TPU_PLATFORM=cpu`` asks for it."""
    platform = os.environ.get("GPR_TPU_PLATFORM")
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "", "cuda", "gpu"):
        raise SystemExit(f"GPR_TPU_PLATFORM={platform}: gpr_tpu_torch runs "
                         "on cuda or cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device; set GPR_TPU_PLATFORM=cpu to run "
                         "on the CPU")
    return torch.device("cuda")


def read_samples(stream) -> np.ndarray:
    # Native fast path: hand the whole input to the C++ parser
    # (io/native.py); falls back to the line-by-line Python reader when no
    # toolchain/library is available.
    try:
        from .io.native import CsvError, parse_csv_bytes

        data = stream.buffer.read() if hasattr(stream, "buffer") else None
        if data is not None:
            try:
                arr = parse_csv_bytes(data)
            except CsvError as e:
                raise SystemExit(str(e))
            if arr is not None:
                return arr
            stream = data.decode().splitlines()  # native lib unavailable
    except AttributeError:
        pass

    rows = []
    d = None
    for i, line in enumerate(stream):
        line = line.strip()
        if not line:
            continue
        try:
            vals = [float(tok) for tok in line.split(",")]
        except ValueError as e:
            raise SystemExit(f"failure '{line}' converting sample: {e}")
        if d is None:
            d = len(vals)
        elif len(vals) != d:
            raise SystemExit(
                f"incompatible dimension of sample in line {i + 1}: {line}"
            )
        rows.append(vals)
    if not rows:
        raise SystemExit("no data")
    return np.asarray(rows, dtype=np.float64)


def _check_flags(args, n, big_dim, inputs):
    """The JAX package's flag checks, in its order and with its messages
    (``gpr_tpu/cli.py:336-465``); the likelihoods' target checks follow in
    ``_check_labels``.  Returns the number of extension flags given (at
    most one passes)."""
    if args.tasks is not None:
        if args.tasks < 2:
            raise SystemExit("-tasks T needs T >= 2")
        if big_dim < 2:
            raise SystemExit(
                "-tasks needs feature columns before the task-id column "
                "(got a single input column)"
            )
        if not 1 <= args.coreg_rank <= args.tasks:
            raise SystemExit("-coreg-rank R needs 1 <= R <= T")
        tcol = inputs[:, -1]
        if (not np.all(tcol == np.round(tcol)) or tcol.min() < 0
                or tcol.max() >= args.tasks):
            raise SystemExit(
                f"-tasks {args.tasks}: the last input column must hold "
                f"integer task ids in 0..{args.tasks - 1}"
            )
        if args.inducing_init == "kmeans":
            raise SystemExit(
                "-inducing-init kmeans is incompatible with -tasks "
                "(centroids would average the integer task-id column); "
                "use random or first"
            )

    n_extensions = sum(
        [args.pitc_block is not None, args.warp > 0, bool(args.classify),
         bool(args.poisson), bool(args.binomial), args.negbin is not None,
         bool(args.ordinal), args.student_t is not None]
    )
    _EXT_FLAGS = ("-pitc-block/-warp/-classify/-poisson/-binomial/-negbin/"
                  "-ordinal/-student-t")
    if n_extensions > 1:
        raise SystemExit(
            f"choose at most one of {_EXT_FLAGS.replace('/', ' / ')}"
        )
    if args.loo and not args.exact:
        # sparse LOO (models/loo.py) trains through the device L-BFGS
        if args.trainer != "device":
            raise SystemExit(
                "-loo needs -exact (dense) or -trainer device (sparse "
                "FITC LOO, models/loo.py)"
            )
        if args.block_size is not None:
            raise SystemExit(
                "-loo needs the materialized cross-covariance; drop "
                "-block-size"
            )
        if n_extensions:
            raise SystemExit(
                f"-loo is regression-only; drop {_EXT_FLAGS}"
            )
        if args.polish:
            raise SystemExit(
                "-polish re-optimizes the evidence and would undo a "
                "-loo fit"
            )
    if args.exact:
        if n_extensions:
            raise SystemExit(f"-exact is regression-only; drop {_EXT_FLAGS}")
        if args.block_size is not None:
            raise SystemExit("-exact is dense by definition; drop "
                             "-block-size (use the sparse engine to stream)")
        if args.trainer == "sharded" or args.devices is not None:
            raise SystemExit("-exact trains on one device (dense chol); "
                             "drop -trainer sharded/-devices")
        if args.checkpoint or args.resume:
            raise SystemExit("-exact training is seconds-scale; "
                             "-checkpoint/-resume are not supported")
        if args.polish:
            raise SystemExit("-polish re-optimizes the sparse objective "
                             "and would undo an -exact fit")
        if args.log_het_sked is not None or args.multiscale:
            raise SystemExit("-log-het-sked/-multiscale are per-inducing-"
                             "point se_fat options; -exact has no inducing "
                             "points")
        if args.cg:
            if args.loo:
                raise SystemExit("-loo's closed form needs the dense "
                                 "factor; drop -cg (or drop -loo)")
            if args.restarts > 1:
                raise SystemExit(
                    "-cg has no cheap exact-evidence VALUE to rank "
                    "restarts by (models/iterative.py scope note); run "
                    "separate -seed fits instead"
                )
        elif n > 20000:
            raise SystemExit(
                f"-exact is O(n^3): {n} rows is past the 20000-row cap; "
                "use the sparse engine (-n-inducing/-block-size) or "
                "-exact -cg (iterative exact)"
            )
    elif args.cg:
        raise SystemExit("-cg modifies -exact; add -exact (the sparse "
                         "engine has no CG path)")
    if n_extensions and args.trainer == "host":
        raise SystemExit(
            f"{_EXT_FLAGS} require -trainer "
            "device|sharded (they train via the device-resident packed "
            "objective)"
        )
    if n_extensions and args.polish:
        raise SystemExit(
            "-polish re-optimizes the FITC regression objective and would "
            f"undo a {_EXT_FLAGS} fit — not "
            "supported together"
        )
    if n_extensions and args.devices is not None and "x" in str(args.devices):
        raise SystemExit(
            f"{_EXT_FLAGS} support 1-D "
            "data-parallel meshes only (-devices N)"
        )
    if args.student_t is not None:
        if args.student_t <= 2.0:
            raise SystemExit(
                "-student-t NU needs NU > 2 (finite noise variance for "
                "the moment-matched predictive; the library API accepts "
                "any NU > 0)"
            )
        if args.checkpoint or args.resume:
            raise SystemExit(
                "-student-t alternates EM rounds whose scale weights are "
                "not in the device checkpoint — -checkpoint/-resume are "
                "not supported (re-run the fit)"
            )
    return n_extensions


def _check_labels(args, targets, trials, n):
    """The JAX package's target checks of the likelihood modes, in its
    order and with its messages (``gpr_tpu/cli.py:467-569``): class labels,
    counts and categories are not centered.  Returns (targets, n_classes,
    target_mean); binary labels come back in {-1, +1}."""
    n_classes = 2
    if args.classify:
        # 0/1 or -1/+1 select the binary Laplace; integer labels 0..C-1
        # with C >= 3 the softmax Laplace
        uniq_arr = np.unique(targets)
        uniq = set(uniq_arr.tolist())
        if uniq <= {0.0, 1.0}:
            targets = 2.0 * targets - 1.0
        elif uniq <= {-1.0, 1.0}:
            pass
        elif (np.all(uniq_arr == np.round(uniq_arr))
              and uniq_arr.min() >= 0 and uniq_arr.max() >= 2
              and uniq_arr.max() < 1024):
            n_classes = int(uniq_arr.max()) + 1
        else:
            raise SystemExit(
                "-classify needs 0/1, -1/+1, or integer 0..C-1 targets, "
                f"got values {sorted(uniq)[:5]}"
            )
        if args.approx == "ep" and n_classes > 2:
            raise SystemExit(
                "-approx ep supports binary -classify only (multi-class "
                "uses the softmax Laplace)"
            )
        if args.approx == "ep" and args.block_size:
            raise SystemExit(
                "-approx ep has no streaming variant; drop -block-size "
                "(the mesh trainer already unbounds n across devices)"
            )
        if args.verbose:
            if n_classes == 2:
                pos = int((targets > 0).sum())
                print(f"classes: {pos} positive / {n - pos} negative",
                      file=sys.stderr)
            else:
                counts = np.bincount(targets.astype(int),
                                     minlength=n_classes)
                print(f"classes: {n_classes} "
                      f"(counts {counts.tolist()})", file=sys.stderr)
        return targets, n_classes, 0.0
    if args.poisson:
        if targets.min() < 0 or not np.all(targets == np.round(targets)):
            raise SystemExit(
                "-poisson needs nonnegative integer counts as targets"
            )
        if args.verbose:
            print(f"counts: mean {targets.mean():.3f}, "
                  f"max {int(targets.max())}", file=sys.stderr)
        return targets, n_classes, 0.0
    if args.binomial:
        if (trials.min() < 1 or not np.all(trials == np.round(trials))
                or targets.min() < 0
                or not np.all(targets == np.round(targets))
                or np.any(targets > trials)):
            raise SystemExit(
                "-binomial needs positive integer trials and integer "
                "successes with 0 <= successes <= trials"
            )
        if args.verbose:
            print(f"proportions: mean {float((targets / trials).mean()):.3f},"
                  f" trials max {int(trials.max())}", file=sys.stderr)
        return targets, n_classes, 0.0
    if args.negbin is not None:
        if args.negbin <= 0:
            raise SystemExit("-negbin needs an initial dispersion R0 > 0")
        if targets.min() < 0 or not np.all(targets == np.round(targets)):
            raise SystemExit(
                "-negbin needs nonnegative integer counts as targets"
            )
        if args.verbose:
            print(f"counts: mean {targets.mean():.3f}, "
                  f"var {targets.var():.3f}, max {int(targets.max())}",
                  file=sys.stderr)
        return targets, n_classes, 0.0
    if args.ordinal:
        uniq_arr = np.unique(targets)
        if (not np.all(uniq_arr == np.round(uniq_arr))
                or uniq_arr.min() < 0 or uniq_arr.max() < 1
                or uniq_arr.max() >= 1024):
            raise SystemExit(
                "-ordinal needs integer category targets 0..K-1 (K >= 2), "
                f"got values {uniq_arr[:5].tolist()}"
            )
        n_classes = int(uniq_arr.max()) + 1
        if args.verbose:
            counts = np.bincount(targets.astype(int), minlength=n_classes)
            print(f"categories: {n_classes} (counts {counts.tolist()})",
                  file=sys.stderr)
        return targets, n_classes, 0.0
    target_mean = float(targets.mean())
    targets = targets - target_mean
    target_variance = float(targets @ targets / n)
    if args.verbose:
        print(f"target variance: {target_variance:.5f}", file=sys.stderr)
    return targets, n_classes, target_mean


def _mesh_shape(args) -> tuple[int, int] | None:
    """(D, M) of -devices DxM; None for -devices N or none."""
    if args.devices is None or "x" not in str(args.devices):
        return None
    try:
        shape = tuple(int(v) for v in str(args.devices).split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise SystemExit(f"-devices needs N >= 1 (or DxM), got "
                         f"{args.devices!r}")
    return shape


def _n_ranks(args, dev) -> int:
    """-devices N or D M of -devices DxM, else every visible card (one rank
    on the CPU)."""
    shape = _mesh_shape(args)
    if shape is not None:
        return shape[0] * shape[1]
    if args.devices is None:
        return torch.cuda.device_count() if dev.type == "cuda" else 1
    try:
        n = int(args.devices)
    except ValueError:
        n = 0
    if n < 1:
        raise SystemExit(f"-devices needs N >= 1 (or DxM), got "
                         f"{args.devices!r}")
    return n


class _Prepared(NamedTuple):
    """The training command's data and starts, as ``_prepare_train`` makes
    them from the flags and the parsed rows."""

    fam: object
    X: torch.Tensor
    y: torch.Tensor
    trials: torch.Tensor | None
    n_inducing: int
    seed: int
    build_params: Callable
    n_extensions: int
    n_classes: int
    target_mean: float
    input_means: np.ndarray
    input_stddevs: np.ndarray


def cmd_train(args, dev) -> int:
    """-cmd train: fit the flags' model to the rows on stdin and write its
    artifact; returns the exit code."""
    if args.resume and args.checkpoint is None:
        raise SystemExit("-resume requires -checkpoint FILE")
    data = read_samples(sys.stdin)
    given = copy.copy(args)  # each rank of -trainer sharded prepares anew
    s = _prepare_train(args, dev, data)
    if args.trainer == "sharded":
        given.seed = s.seed  # one draw of the default seed for every rank
        return _train_sharded(args, given, data, dev, s)
    if args.exact and not s.n_extensions:
        train_exact = _train_exact_cg if args.cg else _train_exact
        return train_exact(args, s.fam, s.X, s.y, s.seed, s.build_params,
                           s.target_mean, s.input_means, s.input_stddevs)

    got_signal = {"flag": False}

    def on_sigint(signum, frame):
        got_signal["flag"] = True

    def stopped():
        return got_signal["flag"]

    old_handler = signal.signal(signal.SIGINT, on_sigint)
    try:
        if s.n_extensions:
            _, result, st, _ = _fit_extension(args, s, dev, stopped)
        elif args.trainer == "device":
            trained = _train_on_device(args, s, dev, stopped)
        else:
            trained = _train_host(args, s, dev, stopped)
    finally:
        signal.signal(signal.SIGINT, old_handler)
    if s.n_extensions:
        return _finish_extension(args, s, result, st)
    return _finish_regression(args, s, trained)


def _prepare_train(args, dev, data) -> _Prepared:
    """The flag and data checks of -cmd train in the JAX package's order,
    the labels' and inputs' normalisation and the per-restart kernel draw,
    on the parsed rows ``data``."""
    fam = _family(args)
    from .kernels.base import kernel_with

    trials = None
    if args.binomial:
        # binomial rows are x..., trials, successes (flag help)
        if data.shape[1] < 3:
            raise SystemExit(
                "-binomial training data needs at least 3 columns "
                "(x..., trials, successes)"
            )
        trials = data[:, -2]
        data = np.delete(data, -2, axis=1)
    if data.shape[1] < 2:
        raise SystemExit("training data needs at least 2 columns (x..., y)")
    inputs, targets = data[:, :-1], data[:, -1]
    n, big_dim = inputs.shape
    n_extensions = _check_flags(args, n, big_dim, inputs)
    if args.tasks is not None:
        from .kernels import icm_family

        fam = icm_family(fam, big_dim - 1, args.tasks, args.coreg_rank)
        args.kernel = fam.name

    targets, n_classes, target_mean = _check_labels(args, targets, trials,
                                                    n)

    input_means = inputs.mean(axis=0)
    # reference parity: "stddev" = sqrt(sum of squared deviations)
    # (bin/ocaml_gpr.ml:262)
    input_stddevs = np.sqrt(((inputs - input_means) ** 2).sum(axis=0))
    input_stddevs = np.where(input_stddevs == 0.0, 1.0, input_stddevs)
    if args.tasks is not None:
        # task ids are categorical: identity transform, stored as such so
        # that -cmd test leaves the ids intact
        input_means[-1] = 0.0
        input_stddevs[-1] = 1.0
    inputs = (inputs - input_means) / input_stddevs

    n_inducing = min(args.n_inducing, n)
    seed = args.seed if args.seed is not None else int(time.time_ns() % (2**31))
    if args.restarts > 1 and (args.checkpoint or args.resume):
        raise SystemExit("-restarts > 1 is incompatible with "
                         "-checkpoint/-resume (single-trajectory state)")
    if args.resume and args.trainer == "sharded":
        raise SystemExit("-resume is not supported with -trainer sharded "
                         "(device-sharded state is mesh-layout dependent)")
    if args.devices is not None and args.trainer != "sharded":
        raise SystemExit("-devices requires -trainer sharded")

    log_sf2 = 2.0 * math.log(args.amplitude)
    X = torch.tensor(inputs, dtype=F64, device=dev)
    # ordinal categories and multi-class labels are integers
    y = (torch.tensor(targets.astype(np.int64), device=dev)
         if args.ordinal or (args.classify and n_classes > 2)
         else torch.tensor(targets, dtype=F64, device=dev))
    trials_t = (torch.tensor(trials, dtype=F64, device=dev)
                if trials is not None else None)

    if fam.name == "se_fat":
        def build_params(rng):
            """Per-restart kernel params: the projection draw is the random
            part (reference init, bin/ocaml_gpr.ml:272-300)."""
            if args.dim_red is not None:
                d = min(big_dim, args.dim_red)
                tproj = rng.uniform(-1.0, 1.0, (big_dim, d)) / big_dim
            else:
                d = big_dim
                tproj = None
            return fam(
                d, log_sf2, tproj=tproj,
                log_hetero_skedasticity=(
                    np.full((n_inducing,), args.log_het_sked)
                    if args.log_het_sked is not None else None
                ),
                log_multiscales_m05=(
                    np.zeros((n_inducing, d)) if args.multiscale else None
                ),
                device=dev, dtype=F64,
            )
    else:
        # -kernel NAME: the family's default hyper init; -amplitude maps
        # onto log_sf2 where the family has a signal-variance hyper
        if (args.dim_red is not None or args.log_het_sked is not None
                or args.multiscale):
            raise SystemExit(
                "-dim-red/-log-het-sked/-multiscale apply to the se_fat "
                f"kernel only (got -kernel {fam.name})"
            )
        has_sf2 = "log_sf2" in fam.param_names
        if args.amplitude != 1.0 and not has_sf2:
            raise SystemExit(
                f"-amplitude needs a signal-variance hyper; -kernel "
                f"{fam.name} has none"
            )

        sm_q = _sm_q(args.kernel)

        def build_params(rng):
            if sm_q is not None:
                # -kernel smQ: empirical-spectrum init, the top peaks for
                # one restart, power-weighted draws seeded from rng for more
                from .kernels import sm_init_from_data

                return sm_init_from_data(
                    sm_q, inputs, targets,
                    key=None if args.restarts == 1
                    else int(rng.integers(2**31)),
                    device=dev, dtype=F64,
                )
            # the JAX package seeds its key with this draw
            gen = torch.Generator(dev).manual_seed(int(rng.integers(2**31)))
            p = fam.default_params(X, n_inducing, gen)
            if has_sf2 and args.amplitude != 1.0:
                p = kernel_with(p, {"log_sf2": torch.tensor(
                    log_sf2, dtype=F64, device=dev)})
            return p

    return _Prepared(fam, X, y, trials_t, n_inducing, seed, build_params,
                     n_extensions, n_classes, target_mean, input_means,
                     input_stddevs)


def _stats_line(trained) -> str:
    from .models import calc_stats

    st = calc_stats(trained)
    return (
        f"MSLL={float(st.msll):7.7f} SMSE={float(st.smse):7.7f} "
        f"MAD={float(st.mad):7.7f} MAXAD={float(st.maxad):7.7f}"
    )


def _train_host(args, s, dev, stopped):
    """-trainer host: ``optim.train`` from each restart's start, keeping
    the highest finite evidence; SIGINT keeps the best model so far."""
    from .optim import Bailout, train

    last_report = {"eval": 0.0, "grad": 0.0}

    def bailout(iter):
        if stopped():
            raise Bailout
        if args.max_iter is not None and iter > args.max_iter:
            raise Bailout

    def report_trained_model(iter, trained):
        bailout(iter)
        if args.verbose and time.time() - last_report["eval"] > 1.0:
            last_report["eval"] = time.time()
            print(f"iter {iter:4d}: {_stats_line(trained)}", file=sys.stderr,
                  flush=True)

    def report_gradient_norm(iter, norm):
        bailout(iter)
        if args.verbose and time.time() - last_report["grad"] > 1.0:
            last_report["grad"] = time.time()
            print(f"iter {iter:4d}: |gradient|={norm:.5f}", file=sys.stderr,
                  flush=True)

    trained = None
    for r in range(max(1, args.restarts)):
        seed_r = s.seed + r
        params_r = s.build_params(np.random.default_rng(seed_r))
        z_r = (
            None if args.inducing_init == "random"
            else _choose_inducing(args, seed_r, params_r, s.X, s.n_inducing)
        )
        cand = train(
            s.fam, s.X, s.y,
            kernel_params=params_r,
            sigma2=args.sigma2,
            inducing=z_r,
            n_rand_inducing=s.n_inducing,
            variational=True,  # Variational_FIC, like the CLI
            block_size=args.block_size,
            step=args.step, tol=args.tol, epsabs=args.eps,
            max_iter=args.max_iter,
            report_trained_model=report_trained_model,
            report_gradient_norm=report_gradient_norm,
            generator=torch.Generator(dev).manual_seed(seed_r),
            checkpoint_path=args.checkpoint,
            resume=args.resume,
        )
        # NaN-safe best: a diverged draw (NaN evidence) must never beat
        # a finite one — every float comparison against NaN is False
        def _key(t):
            l = float(t.l)
            return (math.isfinite(l), l if math.isfinite(l) else 0.0)

        if trained is None or _key(cand) > _key(trained):
            trained = cand
        if args.verbose and args.restarts > 1:
            print(f"restart {r}: log evidence {float(cand.l):.3f}"
                  f" (best {float(trained.l):.3f})", file=sys.stderr)
        if stopped():
            break  # SIGINT: keep the best model found so far
    return trained


def _finish_regression(args, s, trained) -> int:
    """-polish, the -verbose result and the regression artifact."""
    trained = _apply_polish(args, s.X, s.y, trained)
    if args.verbose:
        print(f"result: {_stats_line(trained)}", file=sys.stderr)
    _write_artifact(args, s.fam, trained, s.target_mean, s.input_means,
                    s.input_stddevs)
    return 0


def _train_sharded(args, given, data, dev, s) -> int:
    """-trainer sharded: the fit on -devices N (or D M) spawned ranks
    (``parallel.run_spmd``, each running ``_train_rank`` on the command as
    ``given`` and the parsed rows ``data``), then the artifact from rank
    0's final state, written here on the whole data as the single-device
    trainers write theirs.  SIGINT sets ``stop``: the ranks read it
    together after their in-flight chunk and stop there, and the last
    completed state is written, as with -trainer device."""
    from .models.streaming import streaming_trained
    from .optim.train import TrainResult
    from .parallel import run_spmd

    n_ranks = _n_ranks(args, dev)
    stop = torch.multiprocessing.get_context("spawn").Event()
    old_handler = signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        if args.verbose:
            shape = _mesh_shape(args)
            layout = "" if shape is None else " (a {}x{} mesh)".format(*shape)
            print(f"-trainer sharded: {n_ranks} ranks{layout}",
                  file=sys.stderr, flush=True)
        r, st = run_spmd(_train_rank, n_ranks, given, data, stop)
    finally:
        signal.signal(signal.SIGINT, old_handler)
    st = st._replace(x=st.x.to(dev))
    result = _unpack_state(args, s, st, r, dev)
    if s.n_extensions:
        return _finish_extension(args, s, result, st)
    p, z, s2, _ = result
    trained = streaming_trained(p, z, s2, s.X, s.y, variational=True,
                                block_size=args.block_size or 8192)
    return _finish_regression(args, s, TrainResult(trained, p, z, s2))


def _train_rank(mesh, args, data, stop):
    """One rank of -trainer sharded: the command's preparation on the
    parsed rows ``data``, then its fit with ``mesh`` (the world's 1-D
    mesh, or with -devices DxM the 2-D mesh made from it); returns (the
    winning start, its final optimizer state).  Rank 0 alone reports and
    checkpoints.  After each chunk every rank reads rank 0's view of
    ``stop``, so all of them stop after the same one."""
    if mesh.rank != 0:
        args.verbose, args.checkpoint = False, None
    s = _prepare_train(args, mesh.device, data)

    def stopped():
        flag = torch.tensor(float(stop.is_set()), device=mesh.device)
        return bool(mesh.broadcast(flag))

    if s.n_extensions:
        _, _, st, r = _fit_extension(args, s, mesh.device, stopped, mesh)
        return r, st
    shape = _mesh_shape(args)
    if shape is None:
        return _fit_on_mesh(args, s, mesh, stopped)
    from .parallel import make_mesh_2d

    return _fit_on_mesh(args, s, make_mesh_2d(*shape), stopped)


def _apply_polish(args, X, y, trained):
    """-polish N: f64 finishing step (optim.polish) after any trainer.

    Reruns the same mean-NLL objective in f64 from the trained hypers (a
    row subsample of N bounds the cost; N >= n uses all rows) and rebuilds
    the predictor state from the polished hypers.  The reference never
    needs this (GSL BFGS2 is f64 end to end); the CLI trains in f64 as well,
    so here it is one more f64 L-BFGS phase on the subsample.
    """
    if not args.polish:
        return trained
    from .models.streaming import streaming_trained
    from .optim import make_pack
    from .optim.polish import polish
    from .optim.train import TrainResult

    pack = make_pack(trained.kernel_params, trained.inducing,
                     float(trained.model.sigma2))
    p_f, z_f, s2_f, _, rep = polish(
        X, y, pack, pack.x0, variational=True,
        subsample=min(args.polish, X.shape[0]),
        max_iter=args.max_iter if args.max_iter is not None else 40,
        epsabs=args.eps / max(1, min(args.polish, X.shape[0])),
    )
    if args.verbose:
        print(f"polish (f64, {rep.n_rows} rows): mean-NLL {rep.f0:.6f} -> "
              f"{rep.f:.6f}, |grad| {rep.gnorm0:.2e} -> {rep.gnorm:.2e} "
              f"({rep.n_iter} iters, {rep.wall_s:.0f}s)", file=sys.stderr)
    new = streaming_trained(
        p_f, z_f, s2_f, X, y, variational=True,
        block_size=args.block_size or 8192,
    )
    return TrainResult(new, p_f, z_f, s2_f)


def _choose_inducing(args, seed, params, X, n_inducing):
    """-inducing-init dispatch shared by every trainer path; the random
    draws come from ``torch.Generator`` seeded with ``seed`` (where the JAX
    package takes ``jax.random.PRNGKey(seed)``)."""
    from .models.fitc import (
        choose_kmeans_inputs,
        choose_n_first_inputs,
        choose_n_random_inputs,
    )

    generator = torch.Generator(X.device).manual_seed(seed)
    if args.inducing_init == "kmeans":
        return choose_kmeans_inputs(generator, params, X, n_inducing)
    if args.inducing_init == "first":
        return choose_n_first_inputs(params, X, n_inducing)
    return choose_n_random_inputs(generator, params, X, n_inducing)


def _report_coregionalization(args, kernel):
    """-tasks -verbose: print the learned task covariance B and the
    inter-task correlations (``kernels/task.py`` ``coregionalization``)."""
    if args.tasks is None or not args.verbose:
        return
    with torch.no_grad():
        B = kernel.terms[0].terms[0].coregionalization().cpu().numpy()
    d = np.sqrt(np.maximum(np.diag(B), 1e-30))
    C = B / np.outer(d, d)
    print("coregionalization B (task covariances):", file=sys.stderr)
    for row in B:
        print("  " + " ".join(f"{v:9.4f}" for v in row), file=sys.stderr)
    print("inter-task correlations:", file=sys.stderr)
    for row in C:
        print("  " + " ".join(f"{v:6.3f}" for v in row), file=sys.stderr)


def _write_artifact(args, fam, trained, target_mean, input_means,
                    input_stddevs):
    from .io.checkpoint import artifact_from_trained, save_model

    _report_coregionalization(args, trained.kernel_params)
    save_model(args.model, artifact_from_trained(
        fam, trained, target_mean=target_mean, input_means=input_means,
        input_stddevs=input_stddevs, kernel_params=trained.kernel_params,
    ))


def _start(args, s, r):
    """(kernel, z) of restart r: the kernel draw seeded -seed + r and its
    inducing points (-inducing-init)."""
    params = s.build_params(np.random.default_rng(s.seed + r))
    return params, _choose_inducing(args, s.seed + r, params, s.X,
                                    s.n_inducing)


def _chunk_watch(args, stopped):
    """(on_chunk, last_state): the device L-BFGS's per-chunk callback,
    which keeps the state in ``last_state["st"]``, writes -checkpoint,
    reports under -verbose and raises Bailout once ``stopped()``."""
    from .optim import Bailout

    last_state = {"st": None}

    def on_chunk(st):
        last_state["st"] = st
        if args.checkpoint is not None:
            from .io.resume import save_device_checkpoint

            save_device_checkpoint(args.checkpoint, st)
        if args.verbose:
            print(
                f"iter {int(st.n_iter):4d}: f={float(st.f):.6f} "
                f"|gradient|={float(torch.linalg.norm(st.g)):.5f} "
                f"evals={int(st.n_evals)}", file=sys.stderr, flush=True,
            )
        if stopped():
            raise Bailout

    return on_chunk, last_state


def _regression_fit_kw(args, s):
    """The device L-BFGS settings of the regression trainers."""
    return dict(
        variational=True, step=args.step, tol=args.tol,
        epsabs=args.eps / s.X.shape[0],
        max_iter=args.max_iter if args.max_iter is not None else 100,
    )


def _train_on_device(args, s, dev, stopped):
    """-trainer device: the device-resident chunked L-BFGS
    (optim.lbfgs_device.fit) at the CLI surface.  Same model (variational
    FIC), same artifact schema as the host loop, the mean-NLL objective.
    -eps keeps the host trainer's TOTAL-gradient meaning: mean |g| < eps/n
    <=>  total |g| < eps, so the same flag value stops both trainers at the
    same point.  SIGINT stops after the in-flight chunk and keeps the
    incumbent (the device L-BFGS is monotone, so the incumbent IS the best
    model so far).
    """
    from .models.fitc import calc_model, calc_trained
    from .optim import Bailout, make_pack
    from .optim.lbfgs_device import fit, fit_restarts
    from .optim.train import TrainResult

    X, y = s.X, s.y
    pack = make_pack(*_start(args, s, 0), args.sigma2)
    common = _regression_fit_kw(args, s)
    # -loo (sparse): validated upstream to the device trainer only
    loo_kw = {"objective": "loo"} if args.loo else {}
    on_chunk, last_state = _chunk_watch(args, stopped)

    if args.restarts > 1:
        x0s = [pack.x0] + [make_pack(*_start(args, s, r), args.sigma2).x0
                           for r in range(1, args.restarts)]
        p_f, z_f, s2_f, st, probe_fs = fit_restarts(
            X, y, pack, x0s,
            streaming_block_size=args.block_size, **common, **loo_kw,
        )
        if args.verbose:
            print(f"restart probes: "
                  f"{[round(float(f), 4) for f in probe_fs]}",
                  file=sys.stderr)
    else:
        init_state = None
        if args.resume and os.path.exists(args.checkpoint):
            from .io.resume import load_device_checkpoint

            init_state = load_device_checkpoint(args.checkpoint, device=dev)
            if init_state.x.shape != pack.x0.shape:
                raise SystemExit(
                    "checkpoint hyper vector does not match this "
                    "configuration — resume requires the same "
                    "model/data setup"
                )
        try:
            p_f, z_f, s2_f, st = fit(
                X, y, pack,
                streaming_block_size=args.block_size,
                init_state=init_state, state_callback=on_chunk,
                **common, **loo_kw,
            )
        except Bailout:
            p_f, z_f, s2_f = pack.unpack(last_state["st"].x)

    if args.block_size is not None:
        from .models.streaming import streaming_trained

        trained = streaming_trained(
            p_f, z_f, s2_f, X, y, variational=True,
            block_size=args.block_size,
        )
    else:
        model = calc_model(p_f, X, z_f, s2_f, variational=True,
                           factorization="chol")
        trained = calc_trained(model, y)
    return TrainResult(trained, p_f, z_f, s2_f)


def _fit_on_mesh(args, s, mesh, stopped):
    """-trainer sharded's regression fit on a rank: ``fit_sharded``, on a
    2-D mesh ``fit_sharded_2d`` (or ``fit_restarts_sharded`` with
    -restarts); returns (the winning start, its final state)."""
    from .optim import Bailout, make_pack
    from .parallel import (
        Mesh2D,
        fit_restarts_sharded,
        fit_sharded,
        fit_sharded_2d,
    )

    pack = make_pack(*_start(args, s, 0), args.sigma2)
    common = _regression_fit_kw(args, s)
    block_size = args.block_size or 8192
    if args.restarts > 1:
        x0s = [pack.x0] + [make_pack(*_start(args, s, r), args.sigma2).x0
                           for r in range(1, args.restarts)]
        *_, st, rep = fit_restarts_sharded(
            mesh, s.X, s.y, pack, x0s, block_size=block_size, **common)
        if args.verbose:
            print(f"restart probes (split over {mesh.size} ranks): "
                  f"{[round(float(f), 4) for f in rep]}", file=sys.stderr)
        return rep.winner, st
    on_chunk, last_state = _chunk_watch(args, stopped)
    try:
        fit_one = fit_sharded_2d if isinstance(mesh, Mesh2D) else fit_sharded
        *_, st = fit_one(mesh, s.X, s.y, pack, block_size=block_size,
                         state_callback=on_chunk, **common)
    except Bailout:
        st = last_state["st"]
    return 0, st


def _fit_extension(args, s, dev, stopped, mesh=None):
    """The extension modes at the CLI surface (the JAX package's
    ``_train_extension``).  Each trains through the packed device L-BFGS
    (``optim.fit_packed_objective``); returns (key, result, state, r) of
    the best restart (``_best_restart``), and ``_finish_extension`` writes
    the regression artifact's schema with the mode's extras:

      * -classify (binary), -poisson, -binomial, -negbin R0, -ordinal: the
        Laplace models (``models/classify.py`` and its siblings; dense, or
        streaming with -block-size); coeffs = U^-1 V'a and r_mat = Rn U
        serve the latent posterior through the standard predictors, and
        -cmd test applies the mode's squash or moments;
      * -classify -approx ep: binary EP (``models/classify_ep.py``,
        dense), its state in the same slots, served with the exact probit
        predictive; -classify with C >= 3 classes: the softmax Laplace
        (``models/classify_multi.py``, or ``classify_multi_stream.py``
        with -block-size), its (m, C) coeffs and the per-class quadratic
        forms in the extras;
      * -student-t NU: ``models.robust.fit_t`` (5 EM rounds);
      * -warp K: ``models.warped.fit_warped`` (variational, streaming);
        -cmd test integrates the inverse warp by Gauss-Hermite quadrature;
      * -pitc-block B: the PITC evidence; its artifact serves through the
        standard predictors.

    -restarts N keeps the lowest final mean-NLL objective; -checkpoint and
    -resume follow the device trainer's rules (not with -student-t).

    With ``mesh`` (a rank of -trainer sharded) each fit takes it: the count
    likelihoods, the warp and PITC through their sharded objectives, as the
    JAX package's CLI builds them."""
    from .models.binomial import fit_binomial
    from .models.classify import fit_classify
    from .models.classify_ep import fit_classify_ep
    from .models.classify_multi import fit_classify_multi
    from .models.negbin import fit_negbin
    from .models.ordinal import default_cutpoint_raw, fit_ordinal
    from .models.pitc import pitc_log_evidence
    from .models.poisson import fit_poisson
    from .models.robust import fit_t
    from .models.classify import fit_laplace
    from .models.warped import (
        default_warp_params,
        fit_warped,
        make_warped_pack,
    )
    from .optim import Bailout, make_pack
    from .optim.lbfgs_device import fit_packed_objective, value_and_grad
    from .parallel import (
        shard_batch,
        sharded_binomial_log_evidence,
        sharded_negbin_log_evidence,
        sharded_pitc_log_evidence,
        sharded_poisson_log_evidence,
        sharded_warped_log_evidence,
    )

    X, y, trials, n_classes = s.X, s.y, s.trials, s.n_classes
    n = X.shape[0]
    max_iter = args.max_iter if args.max_iter is not None else 100
    block_size = args.block_size or 8192
    on_chunk, last_state = _chunk_watch(args, stopped)

    def load_resume_state(pack_x0):
        if not args.resume or not os.path.exists(args.checkpoint):
            return None
        from .io.resume import load_device_checkpoint

        init_state = load_device_checkpoint(args.checkpoint, device=dev)
        if init_state.x.shape != pack_x0.shape:
            raise SystemExit(
                "checkpoint hyper vector does not match this configuration "
                "— resume requires the same model/data setup"
            )
        return init_state

    common = dict(step=args.step, tol=args.tol, epsabs=args.eps / n,
                  max_iter=max_iter, state_callback=on_chunk)

    def fit_mesh(evidence, pack, data, x0):
        """The mean-NLL fit of a sharded ``evidence(x, *data)`` over this
        rank's ``data`` (the count likelihoods, the warp, PITC)."""
        return fit_laplace(evidence, pack, data, True, n, mesh=mesh,
                           init_state=load_resume_state(x0), **common)

    def run_one(r):
        """One fit from start r: ((kernel, z, sigma2 or the dispersion,
        the warp or the cutpoint raws), state)."""
        params0, z0 = _start(args, s, r)
        laplace = dict(block_size=args.block_size, mesh=mesh, **common)
        shards = None if mesh is None else shard_batch(mesh, X, y)
        if args.classify or args.poisson or args.binomial:
            pack = make_pack(params0, z0, 1.0, learn_sigma2=False)
            init = load_resume_state(pack.x0)
            if args.classify and n_classes > 2:
                p, z, st = fit_classify_multi(X, y, pack, n_classes,
                                              init_state=init, **laplace)
            elif args.classify and args.approx == "ep":
                p, z, st = fit_classify_ep(X, y, pack, init_state=init,
                                           mesh=mesh, **common)
            elif args.classify:
                p, z, st = fit_classify(X, y, pack, init_state=init,
                                        **laplace)
            elif mesh is not None:
                # the count likelihoods: binomial's trials shard too
                evidence, rows = (
                    (sharded_poisson_log_evidence, ()) if args.poisson
                    else (sharded_binomial_log_evidence,
                          (shard_batch(mesh, X, trials)[1],)))

                def counts(x, Xs, ys, ms):
                    kernel, z, _ = pack.unpack(x)
                    return evidence(kernel, mesh, z, Xs, ys, *rows, ms)

                st = fit_mesh(counts, pack, shards, pack.x0)
                p, z, _ = pack.unpack(st.x)
            elif args.poisson:
                p, z, st = fit_poisson(X, y, pack, init_state=init,
                                       **common, block_size=args.block_size)
            else:
                p, z, st = fit_binomial(X, y, trials, pack, init_state=init,
                                        **common, block_size=args.block_size)
            return (p, z, None, None), st
        if args.ordinal:
            pack = make_pack(params0, z0, 1.0, learn_sigma2=False)
            cut0 = default_cutpoint_raw(n_classes, dtype=X.dtype, device=dev)
            p, z, cut_raw, st = fit_ordinal(
                X, y, pack, cut0,
                init_state=load_resume_state(torch.cat([pack.x0, cut0])),
                **laplace)
            return (p, z, None, cut_raw), st
        if args.negbin is not None:
            # the pack's positive sigma2 slot carries the NB dispersion r
            pack = make_pack(params0, z0, args.negbin)
            if mesh is None:
                p, z, r_disp, st = fit_negbin(
                    X, y, pack, init_state=load_resume_state(pack.x0),
                    **common, block_size=args.block_size)
            else:
                def negbin(x, Xs, ys, ms):
                    kernel, z, r = pack.unpack(x)
                    return sharded_negbin_log_evidence(kernel, mesh, z, Xs,
                                                       ys, r, ms)

                st = fit_mesh(negbin, pack, shards, pack.x0)
                p, z, r_disp = pack.unpack(st.x)
            if args.verbose:
                print(f"negbin: learned dispersion r = {float(r_disp):.4f} "
                      f"(started at {args.negbin:g}; larger = closer to "
                      f"Poisson)", file=sys.stderr)
            return (p, z, r_disp, None), st
        pack = make_pack(params0, z0, args.sigma2)
        if args.student_t is not None:
            n_em = 5
            p, z, s2, lam, st = fit_t(
                X, y, pack, nu=args.student_t, n_em=n_em, mesh=mesh,
                m_step_iters=max(5, max_iter // n_em),
                **{k: v for k, v in common.items() if k != "max_iter"},
            )
            if args.verbose:
                lam_np = lam.cpu().numpy()
                print(
                    f"student-t: {int((lam_np < 0.1).sum())} rows "
                    f"downweighted below 0.1 (min lam "
                    f"{float(lam_np.min()):.4f})", file=sys.stderr,
                )
            return (p, z, s2, None), st
        if args.warp:
            wp0 = default_warp_params(args.warp, device=dev, dtype=X.dtype)
            if mesh is None:
                p, z, s2, wp, st = fit_warped(
                    X, y, pack, wp0, variational=True, block_size=block_size,
                    init_state=load_resume_state(torch.cat([
                        pack.x0, pack.x0.new_zeros(3 * args.warp)])),
                    **common,
                )
                return (p, z, s2, wp), st
            pack_w, unpack_w = make_warped_pack(pack, wp0)

            def warped(x, Xs, ys, ms):
                kernel, z, sigma2, wp = unpack_w(x)
                return sharded_warped_log_evidence(
                    kernel, mesh, wp, z, sigma2, Xs, ys, ms,
                    variational=True, block_size=block_size)

            st = fit_mesh(warped, pack_w, shards, pack_w.x0)
            return unpack_w(st.x), st

        if mesh is None:
            def neg(x, X, y):
                params, z, sigma2 = pack.unpack(x)
                return -(1.0 / n) * pitc_log_evidence(
                    params, z, sigma2, X, y, block_size=args.pitc_block)

            st = fit_packed_objective(value_and_grad(neg), pack, (X, y),
                                      init_state=load_resume_state(pack.x0),
                                      **common)
        else:
            def pitc(x, Xs, ys, ms):
                kernel, z, sigma2 = pack.unpack(x)
                return sharded_pitc_log_evidence(
                    kernel, mesh, z, sigma2, Xs, ys, ms,
                    block_size=args.pitc_block)

            st = fit_mesh(pitc, pack, shards, pack.x0)
        p, z, s2 = pack.unpack(st.x)
        return (p, z, s2, None), st

    return _best_restart(args, s, run_one, stopped, last_state, dev)


def _finish_extension(args, s, result, st) -> int:
    """The -verbose result and the extension mode's artifact."""
    if args.verbose:
        print(f"result: objective={float(st.f):.6f} "
              f"|gradient|={float(torch.linalg.norm(st.g)):.2e}",
              file=sys.stderr)
    _write_extension_artifact(args, s.fam, result, s.X, s.y, s.target_mean,
                              s.input_means, s.input_stddevs,
                              args.block_size or 8192, s.n_classes, s.trials)
    return 0


def _best_restart(args, s, run_one, stopped, last_state, dev):
    """(key, result, state, r) of the best of -restarts fits ``run_one(r)``
    (the lowest final mean-NLL objective; NaN never wins)."""
    from .optim import Bailout

    best = None
    for r in range(max(1, args.restarts)):
        try:
            result, st = run_one(r)
        except Bailout:
            st = last_state["st"]
            if st is None:
                raise SystemExit("interrupted before the first iteration")
            result = _unpack_state(args, s, st, r, dev)
        # NaN-safe best (lower mean NLL wins; NaN never beats finite)
        f = float(st.f)
        key_ = (not math.isfinite(f), f if math.isfinite(f) else 0.0)
        if best is None or key_ < best[0]:
            best = (key_, result, st, r)
        if args.verbose and args.restarts > 1:
            print(f"restart {r}: objective {f:.6f} "
                  f"(best {float(best[2].f):.6f})", file=sys.stderr)
        if stopped():
            break
    return best


def _unpack_state(args, s, st, r, dev):
    """(kernel, z, sigma2 or the dispersion, the warp or the cutpoint raws)
    of an optimizer state from start r: a bailed-out extension fit's, or
    the final state that the ranks of -trainer sharded hand back."""
    from .models.warped import default_warp_params, make_warped_pack
    from .optim import extend_pack, make_pack

    params0, z0 = _start(args, s, r)
    if args.classify or args.poisson or args.binomial or args.ordinal:
        pack = make_pack(params0, z0, 1.0, learn_sigma2=False)
        if not args.ordinal:
            return (*pack.unpack(st.x)[:2], None, None)
        # the K-1 cutpoint raws ride after the base coordinates
        k1 = int(st.x.shape[0]) - int(pack.x0.shape[0])
        ext = extend_pack(pack, pack.x0.new_zeros(k1))
        return (*ext.unpack(st.x)[:2], None, ext.unpack_extra(st.x))
    if args.negbin is not None:
        return (*make_pack(params0, z0, args.negbin).unpack(st.x), None)
    pack = make_pack(params0, z0, args.sigma2)
    if args.warp:
        wp0 = default_warp_params(args.warp, device=dev,
                                  dtype=pack.x0.dtype)
        return make_warped_pack(pack, wp0)[1](st.x)
    return (*pack.unpack(st.x), None)


def _laplace_likelihood(args, y, s2, cut_raw, trials):
    """(parts, loglik, lik, lik_is_row, dense Newton steps, extras) of the
    Laplace mode the flags select, at the trained dispersion ``s2``
    (-negbin) or cutpoint raws (-ordinal)."""
    from .models import binomial, classify, negbin, ordinal, poisson

    zeros = torch.zeros_like(y, dtype=torch.float64)
    if args.ordinal:
        cuts = ordinal.cutpoints_from_raw(cut_raw)
        return (ordinal.ord_parts, ordinal.ord_loglik, (y, cuts),
                (True, False), 20,
                {"ordinal": np.asarray(int(cut_raw.shape[0]) + 1),
                 "cutpoints": cuts.cpu().numpy()})
    if args.poisson:
        return (poisson.pois_parts, poisson.pois_loglik, (y, zeros), None,
                20, {"poisson": np.asarray(1)})
    if args.binomial:
        # the served squash is the classifier's: a classify artifact with a
        # provenance marker
        return (binomial.bin_parts, binomial.bin_loglik, (y, trials), None,
                15, {"classify": np.asarray(2), "binomial": np.asarray(1)})
    if args.negbin is not None:
        r = torch.as_tensor(s2, dtype=y.dtype, device=y.device)
        return (negbin.nb_parts, negbin.nb_loglik, (y, r, zeros),
                (True, False, True), 20, {"negbin": np.asarray(float(r))})
    return (classify.logit_parts, classify.logit_loglik, (y,), None, 15,
            {"classify": np.asarray(2)})


def _laplace_artifact(args, p, z, s2, cut_raw, X, y, trials):
    """(coeffs, chol_km, r_mat, extras) of a Laplace model: the mode's
    coeffs = U^-1 V'a and r_mat = Rn U, so the standard predictors give the
    latent posterior's mean and variance.  Dense: the family's default
    Newton steps; with -block-size: the streaming state of
    ``stream_laplace_parts`` at its default 15 steps, as the JAX package's
    writer."""
    from .models.classify import _fitc_prior, mode_factor
    from .models.classify_stream import stream_laplace_parts
    from .models.ift import W_FLOOR, newton_scan_generic, tmatmul
    from .numerics.linalg import matmul, solve_tri

    parts, loglik, lik, is_row, steps, extra = _laplace_likelihood(
        args, y, s2, cut_raw, trials)
    if args.block_size:
        inducing, _, _, _, vta, rn, *_ = stream_laplace_parts(
            p, z, X, lik, parts=parts, loglik=loglik, lik_is_row=is_row,
            block_size=args.block_size)
    else:
        inducing, v, d = _fitc_prior(p, z, X)
        mask = torch.ones(y.shape, dtype=X.dtype, device=X.device)
        f_hat, a = newton_scan_generic(parts, v, d, lik, mask,
                                       newton_iters=steps)
        _, w = parts(f_hat, lik, mask)
        rn = mode_factor(v, d, torch.maximum(w, w.new_tensor(W_FLOOR)))
        vta = tmatmul(v, a)
    return (solve_tri(inducing.chol_km, vta), inducing.chol_km,
            matmul(rn, inducing.chol_km), extra)


def _classify_ext_artifact(args, p, z, X, y, n_classes):
    """(inducing z, coeffs, chol_km, r_mat, extras) of the multi-class and
    the EP classifiers, as the JAX package writes them.  Multi-class: the
    softmax Laplace's m-space state (dense, or streamed by -block-size),
    coeffs (m, C), the per-class quadratic forms in ``mc_a_tilde`` and
    ``mc_b_tilde`` (r_mat = chol_km, unused by its serving); EP: coeffs and
    r_mat = R U of ``ep_posterior_state`` (the probit predictive's state in
    the standard predictor's slots)."""
    from .numerics.linalg import matmul

    if n_classes > 2:
        if args.block_size:
            from .models.classify_multi_stream import stream_multiclass_state

            inducing, coeffs, a_tilde, b_tilde = stream_multiclass_state(
                p, z, X, y, n_classes, block_size=args.block_size)
        else:
            from .models.classify_multi import multiclass_posterior_state

            inducing, coeffs, a_tilde, b_tilde = multiclass_posterior_state(
                p, z, X, y, n_classes)
        return (inducing.z, coeffs, inducing.chol_km, inducing.chol_km, {
            "classify": np.asarray(n_classes),
            "mc_a_tilde": a_tilde.cpu().numpy(),
            "mc_b_tilde": b_tilde.cpu().numpy()})
    from .models.classify_ep import ep_posterior_state

    inducing, coeffs, rn = ep_posterior_state(p, z, X, y)
    return (inducing.z, coeffs, inducing.chol_km,
            matmul(rn, inducing.chol_km),
            {"classify": np.asarray(2), "ep": np.asarray(1)})


@torch.no_grad()
def _write_extension_artifact(args, fam, result, X, y, target_mean,
                              input_means, input_stddevs, block_size,
                              n_classes=2, trials=None):
    """Save the predictor artifact of an extension mode: the standard
    schema (inducing, coeffs, chol_km, r_mat), so -cmd test serves every
    mode through the same algebra, and the mode's extras as the JAX package
    writes them."""
    from .io.checkpoint import (
        ModelArtifact,
        kernel_params_of,
        save_model,
        warp_extras,
    )

    p, z, s2, wp = result
    if args.classify and (n_classes > 2 or args.approx == "ep"):
        z, coeffs, chol_km, r_mat, extra = _classify_ext_artifact(
            args, p, z, X, y, n_classes)
        sigma2 = 0.0
    elif (args.classify or args.poisson or args.binomial or args.ordinal
            or args.negbin is not None):
        coeffs, chol_km, r_mat, extra = _laplace_artifact(
            args, p, z, s2, wp, X, y, trials)
        sigma2 = 0.0
    elif args.student_t is not None:
        # the converged robust posterior IS a heteroskedastic FITC
        # posterior; the artifact's sigma2 carries the moment-matched t
        # noise variance, so the standard test path serves it
        from .models.fitc import calc_model, calc_trained
        from .models.robust import t_em_sweeps

        nu = float(args.student_t)
        lam, _ = t_em_sweeps(p, z, s2, X, y, nu=nu, sweeps=10)
        model = calc_model(p, X, z, s2 / lam)
        trained = calc_trained(model, y)
        coeffs, chol_km, r_mat = (trained.coeffs, model.inducing.chol_km,
                                  model.r_mat)
        z = model.inducing.z
        sigma2 = float(s2) * nu / (nu - 2.0)
        extra = {"student_t": np.asarray(nu),
                 "t_scale": np.asarray(float(s2))}
    elif wp is not None:  # warped
        from .models.streaming import streaming_trained
        from .models.warped import warp

        trained = streaming_trained(p, z, s2, X, warp(wp, y),
                                    variational=True, block_size=block_size)
        coeffs, chol_km, r_mat = (trained.coeffs,
                                  trained.model.inducing.chol_km,
                                  trained.model.r_mat)
        z = trained.model.inducing.z
        sigma2 = float(s2)
        extra = warp_extras(wp)
    else:  # PITC
        from .models.pitc import pitc_coeffs

        inducing, r_mat, coeffs = pitc_coeffs(p, z, s2, X, y,
                                              block_size=args.pitc_block)
        chol_km, z = inducing.chol_km, inducing.z
        sigma2 = float(s2)
        extra = {"pitc_block": np.asarray(args.pitc_block)}

    _report_coregionalization(args, p)
    host = [t.detach().cpu().numpy() for t in (z, coeffs, chol_km, r_mat)]
    save_model(args.model, ModelArtifact(
        family_name=fam.name, kernel_params=kernel_params_of(p),
        inducing=host[0], coeffs=host[1], chol_km=host[2], r_mat=host[3],
        sigma2=sigma2, target_mean=target_mean, input_means=input_means,
        input_stddevs=input_stddevs,
    ), extra_arrays=extra)


def _train_exact(args, fam, X, y, seed, build_params, target_mean,
                 input_means, input_stddevs) -> int:
    """-exact: dense GP hyper training (``models.exact.fit_exact``) over
    the exact evidence or, with -loo, the LOO pseudo-likelihood; -restarts
    draws fresh kernel inits, each hyper jittered by N(0, 1) draws from
    ``np.random.default_rng(10_000 + seed + r)`` in the JAX package's leaf
    order, and keeps the best objective.  The artifact reuses the standard
    schema: the training inputs as the inducing set, alpha as the coeffs
    and chol(K + sigma2 I) in the chol_km and r_mat slots, tagged exact=1
    in the extras."""
    from .io.checkpoint import ModelArtifact, kernel_params_of, save_model
    from .kernels.base import declared_names, field_of, kernel_with
    from .models.exact import fit_exact, loo_log_likelihood, loo_posterior

    objective = "loo" if args.loo else "evidence"
    best = None
    for r in range(max(1, args.restarts)):
        params0 = build_params(np.random.default_rng(seed + r))
        if r > 0:
            # -exact has no inducing draw to diversify restarts, and the
            # deterministic defaults (se_iso's zeros) repeat: jitter every
            # hyper by ~1 log unit, leaf by leaf in JAX's tree order
            jrng = np.random.default_rng(10_000 + seed + r)
            params0 = kernel_with(params0, {
                name: v + torch.as_tensor(jrng.normal(0.0, 1.0,
                                                      tuple(v.shape)),
                                          dtype=v.dtype, device=v.device)
                for name in declared_names(type(params0))
                if (v := field_of(params0, name)) is not None})
        trained, params, sigma2 = fit_exact(
            params0, X, y, args.sigma2, objective=objective,
            max_iter=args.max_iter if args.max_iter is not None else 100,
            # the packed objective is mean-scaled, so -eps applies per
            # point, as with -trainer device
            step=args.step, tol=args.tol, epsabs=args.eps / X.shape[0],
        )
        score = (float(loo_log_likelihood(trained)) if args.loo
                 else float(trained.l))
        if not math.isfinite(score):
            continue
        if best is None or score > best[0]:
            best = (score, trained, params, sigma2)
        if args.verbose and args.restarts > 1:
            print(f"restart {r}: {objective} {score:.3f} "
                  f"(best {best[0]:.3f})", file=sys.stderr)
    if best is None:
        raise SystemExit("-exact training diverged (non-finite objective); "
                         "try a different -sigma2 / -seed")
    _, trained, params, sigma2 = best

    if args.verbose:
        mu, _ = loo_posterior(trained)
        y_np = trained.y.cpu().numpy()
        resid = y_np - mu.cpu().numpy()
        smse = float((resid ** 2).mean() / np.var(y_np))
        print(f"result: log evidence {float(trained.l):.3f}, "
              f"LOO log p {float(loo_log_likelihood(trained)):.3f}, "
              f"LOO SMSE {smse:.5f}, sigma2 {float(sigma2):.6f}",
              file=sys.stderr)

    chol_a = trained.model.chol_a.cpu().numpy()
    save_model(args.model, ModelArtifact(
        family_name=fam.name, kernel_params=kernel_params_of(params),
        inducing=trained.model.z.detach().cpu().numpy(),
        coeffs=trained.alpha.cpu().numpy(), chol_km=chol_a, r_mat=chol_a,
        sigma2=float(sigma2), target_mean=target_mean,
        input_means=input_means, input_stddevs=input_stddevs,
    ), extra_arrays={"exact": np.float64(1.0)})
    return 0


def _train_exact_cg(args, fam, X, y, seed, build_params, target_mean,
                    input_means, input_stddevs) -> int:
    """-exact -cg: the iterative exact GP (``models.iterative``).

    Hypers train by SGD on unbiased stochastic exact-evidence gradients
    (``fit_iter``: Hutchinson probes with the Nystrom preconditioner as
    control variate, -max-iter steps, default 60, rate -step); the
    posterior coefficients come from one tight preconditioned CG solve
    (tol 1e-6, 400 iterations).  The probes and anchor rows come from a
    ``torch.Generator`` seeded with the seed.  The artifact is the JAX
    package's: the training inputs in the inducing slot, alpha in coeffs, a
    1 x 1 identity where no dense factor exists, tagged exact_cg=1 with the
    standardized training inputs (cg_x) and the anchor count (cg_anchors),
    so that ``-cmd test -with-stddev`` re-solves by CG.
    """
    from .io.checkpoint import ModelArtifact, kernel_params_of, save_model
    from .kernels.base import kernel_with
    from .models.iterative import fit_iter, iter_trained

    n = X.shape[0]
    anchors = min(max(args.n_inducing, 1), n)
    n_steps = args.max_iter if args.max_iter is not None else 60
    params0 = build_params(np.random.default_rng(seed))

    # SGD needs a scale-aware init that L-BFGS does not: the reference's
    # ssqr input standardization leaves inputs spanning ~n^-1/2, so a
    # log_ell = 0 start makes the kernel constant and the clipped SGD
    # loses the race to the all-noise basin.  A median-pairwise-distance
    # ell and a target-variance sf2 (numpy draws, as the JAX package's);
    # -amplitude / -sigma2 override when set away from their defaults.
    tv = float(torch.dot(y, y) / n)
    names = type(params0).param_names
    upd = {}
    if "log_ell" in names:
        sub = X.cpu().numpy()[np.random.default_rng(seed).choice(
            n, min(256, n), replace=False)]
        d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
        ell0 = float(np.sqrt(np.median(d2[d2 > 0])) / 2.0)
        upd["log_ell"] = np.log(ell0)
    if "log_sf2" in names and args.amplitude == 1.0:
        upd["log_sf2"] = np.log(max(tv, 1e-8))
    if upd:
        params0 = kernel_with(params0, {
            k: torch.tensor(v, dtype=X.dtype, device=X.device)
            for k, v in upd.items()})
    sigma2_0 = args.sigma2 if args.sigma2 != 1.0 else max(tv / 4.0, 1e-8)

    def cb(step, params, sigma2, info):
        if step % 10 == 0 or step == n_steps - 1:
            print(f"sgd step {step:4d}: sigma2 {float(sigma2):.5f} "
                  f"cg iters {int(info['iters'])} relres "
                  f"{float(torch.max(info['relres'])):.2e}",
                  file=sys.stderr, flush=True)

    gen = torch.Generator(X.device).manual_seed(seed)
    params, sigma2 = fit_iter(params0, X, y, sigma2_0, generator=gen,
                              n_steps=n_steps, eta0=args.step,
                              n_inducing=anchors,
                              callback=cb if args.verbose else None)
    trained = iter_trained(params, X, y, sigma2, n_inducing=anchors,
                           generator=gen, tol=1e-6, max_iter=400)
    if args.verbose:
        print(f"final solve: {trained.iters} CG iters, relres "
              f"{float(trained.relres):.2e}, sigma2 {float(sigma2):.6f}",
              file=sys.stderr)

    eye1 = np.eye(1, dtype=np.float64)
    save_model(args.model, ModelArtifact(
        family_name=fam.name, kernel_params=kernel_params_of(params),
        inducing=trained.z.detach().cpu().numpy(),
        coeffs=trained.alpha.cpu().numpy(),
        chol_km=eye1,  # no dense factor exists; variances re-solve by CG
        r_mat=eye1, sigma2=float(sigma2), target_mean=target_mean,
        input_means=input_means, input_stddevs=input_stddevs,
    ), extra_arrays={
        "exact_cg": np.float64(1.0),
        "cg_x": X.cpu().numpy().astype(np.float64),
        "cg_anchors": np.float64(anchors),
    })
    return 0


def cmd_test(args, dev) -> int:
    from .convert import params_from_artifact
    from .io.checkpoint import load_model
    from .models.predict import (
        CoVariancePredictor,
        MeanPredictor,
        predict_means,
        predict_variances,
    )

    art, extra = load_model(args.model)
    data = read_samples(sys.stdin)
    big_dim = art.input_means.shape[0]
    if data.shape[1] != big_dim:
        raise SystemExit(
            f"incompatible dimension of inputs ({data.shape[1]}), expected "
            f"{big_dim}"
        )
    inputs = (data - art.input_means) / art.input_stddevs
    X = torch.tensor(inputs, dtype=F64, device=dev)
    kernel, z, sigma2 = params_from_artifact(art, device=dev, dtype=F64)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=F64, device=dev)

    mp = MeanPredictor(z=z, coeffs=t(art.coeffs))
    cvp = CoVariancePredictor(z=z, chol_km=t(art.chol_km),
                              r_mat=t(art.r_mat))
    if "classify" in extra and int(extra["classify"]) > 2:
        # the softmax Laplace's artifact, before the binary squash below
        sys.stdout.write(serve_multiclass(kernel, z, art, extra, X,
                                          args.with_stddev))
        return 0
    if any(key in extra for key in LAPLACE_EXTRAS):
        with torch.no_grad():
            mu = predict_means(kernel, mp, X).cpu().numpy()
            var = predict_variances(kernel, cvp, X, 0.0,
                                    predictive=False).cpu().numpy()
        sys.stdout.write(serve_laplace(extra, mu, var, args.with_stddev))
        return 0
    if "exact_cg" in extra:
        means, variances = serve_exact_cg(kernel, art, extra, X,
                                          with_stddev=args.with_stddev,
                                          predictive=args.predictive)
        _write_predictions(means + art.target_mean, variances)
        return 0
    if "exact" in extra:
        means, variances = serve_exact(kernel, art, X,
                                       with_stddev=args.with_stddev,
                                       predictive=args.predictive)
        _write_predictions(means + art.target_mean, variances)
        return 0
    if "warp_log_a" in extra:
        # warped artifact: the latent posterior is Gaussian in t-space;
        # observation-space moments integrate the inverse warp by
        # Gauss-Hermite quadrature (the predictive t-variance: the observed
        # y carries the noise through the warp)
        from .convert import warp_from_jax
        from .models.warped import WARP_FIELDS, warped_predict_moments

        wp = warp_from_jax({f: extra[f"warp_{f}"] for f in WARP_FIELDS},
                           device=dev, dtype=F64)
        with torch.no_grad():
            mu = predict_means(kernel, mp, X)
            var = predict_variances(kernel, cvp, X, sigma2, predictive=True)
            mean_y, var_y = warped_predict_moments(wp, mu,
                                                   torch.clamp(var, min=0.0))
        _write_predictions(mean_y.cpu().numpy() + art.target_mean,
                           var_y.cpu().numpy() if args.with_stddev else None)
        return 0
    with torch.no_grad():
        means = predict_means(kernel, mp, X).cpu().numpy() + art.target_mean
        if args.with_stddev:
            variances = predict_variances(
                kernel, cvp, X, sigma2, predictive=args.predictive
            ).cpu().numpy()
        else:
            variances = None
    _write_predictions(means, variances)
    return 0


#: the extras of the Laplace artifacts, in the JAX package's order of
#: dispatch
LAPLACE_EXTRAS = ("poisson", "negbin", "ordinal", "classify")


def serve_laplace(extra, mu, var, with_stddev=False) -> str:
    """The text -cmd test prints for a Laplace artifact from the latent
    posterior's means ``mu`` and variances ``var`` (numpy, f64): the
    lognormal rate moments (poisson), the NB law of total variance with
    the learned dispersion (negbin), the exact Gaussian integrals of the
    probit cells, one column a category (ordinal), or MacKay's probit
    squash of the logit (classify, binomial) or, for an EP artifact, the
    exact probit predictive Phi(mu / sqrt(1 + var)); -with-stddev adds the
    rate's, the count's or the latent's standard deviation."""
    if "poisson" in extra or "negbin" in extra:
        var = np.maximum(var, 0.0)
        if "poisson" in extra:
            mean = np.exp(mu + 0.5 * var)
            sd = np.sqrt(np.maximum(
                (np.exp(var) - 1.0) * np.exp(2.0 * mu + var), 0.0))
        else:
            r_disp = float(extra["negbin"])
            mean = np.exp(mu + 0.5 * var)
            m2 = np.exp(2.0 * mu + 2.0 * var)
            sd = np.sqrt(np.maximum(
                mean + (1.0 + 1.0 / r_disp) * m2 - mean * mean, 0.0))
        if with_stddev:
            return "".join(f"{m:f},{s:f}\n" for m, s in zip(mean, sd))
        return "".join(f"{m:f}\n" for m in mean)
    if "ordinal" in extra:
        from scipy.special import ndtr

        var = np.maximum(var, 1e-12)
        cuts = np.asarray(extra["cutpoints"])
        scale = 1.0 / np.sqrt(1.0 + var)
        cdf = ndtr((cuts[None, :] - mu[:, None]) * scale[:, None])
        upper = np.concatenate([cdf, np.ones((len(mu), 1))], axis=1)
        lower = np.concatenate([np.zeros((len(mu), 1)), cdf], axis=1)
        probs = np.maximum(upper - lower, 0.0)
        lines = []
        for p_row, v in zip(probs, var):
            cols = [f"{p:f}" for p in p_row]
            if with_stddev:
                cols.append(f"{math.sqrt(v):f}")
            lines.append(",".join(cols) + "\n")
        return "".join(lines)
    var = np.maximum(var, 0.0)
    if "ep" in extra:
        from scipy.special import ndtr

        prob = ndtr(mu / np.sqrt(1.0 + var))
    else:
        prob = 1.0 / (1.0 + np.exp(-mu / np.sqrt(1.0 + np.pi * var / 8.0)))
    if with_stddev:
        return "".join(f"{p:f},{math.sqrt(v):f}\n"
                       for p, v in zip(prob, var))
    return "".join(f"{p:f}\n" for p in prob)


#: Monte Carlo draws of a multi-class artifact's class probabilities
MC_SERVE_SAMPLES = 2048


@torch.no_grad()
def serve_multiclass(kernel, z, art, extra, X, with_stddev=False) -> str:
    """The text -cmd test prints for a multi-class artifact at X (on the
    device): one probability column a class, the Monte Carlo softmax
    average of ``multiclass_predict_from_state`` over MC_SERVE_SAMPLES
    draws from ``torch.Generator(X.device).manual_seed(0)`` (the JAX
    package draws from its own key 0, so the columns agree with its to
    Monte Carlo error), then with -with-stddev the C latent standard
    deviations (equal to the JAX package's)."""
    from .models.classify_multi import multiclass_predict_from_state

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=F64, device=X.device)

    probs, _, sigma = multiclass_predict_from_state(
        kernel, z, t(art.coeffs), t(extra["mc_a_tilde"]),
        t(extra["mc_b_tilde"]), X, n_samples=MC_SERVE_SAMPLES,
        generator=torch.Generator(X.device).manual_seed(0))
    probs = probs.cpu().numpy()
    sd = np.sqrt(np.maximum(np.diagonal(sigma.cpu().numpy(), axis1=1,
                                        axis2=2), 0.0))
    lines = []
    for p_row, s_row in zip(probs, sd):
        cols = [f"{v:f}" for v in p_row]
        if with_stddev:
            cols += [f"{v:f}" for v in s_row]
        lines.append(",".join(cols) + "\n")
    return "".join(lines)


def _write_predictions(means, variances=None):
    """One line a point: the mean, and the standard deviation where
    ``variances`` are given."""
    if variances is None:
        lines = [f"{mean:f}\n" for mean in means]
    else:
        lines = [f"{mean:f},{math.sqrt(max(var, 0.0)):f}\n"
                 for mean, var in zip(means, variances)]
    sys.stdout.write("".join(lines))


#: test rows an exact-GP prediction takes at a time: K(X*, X) of a block at
#: the 20,000-row cap is 1.3 GB in f64
EXACT_SERVE_ROWS = 8192


@torch.no_grad()
def serve_exact(kernel, art, X, *, with_stddev=False, predictive=False):
    """(means, variances or None) of an exact-GP artifact at X (on the
    device), EXACT_SERVE_ROWS rows at a time: the training inputs are the
    artifact's inducing set, alpha its coeffs, chol(K + sigma2 I) its
    chol_km (``models.exact``)."""
    from .models.exact import (
        ExactModel,
        ExactTrained,
        predict_means_exact,
        predict_variances_exact,
    )

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=F64, device=X.device)

    tr = ExactTrained(
        model=ExactModel(z=t(art.inducing), sigma2=t(art.sigma2),
                         chol_a=t(art.chol_km)),
        y=t(np.zeros(art.inducing.shape[0])), alpha=t(art.coeffs),
        l=t(0.0))
    blocks = [X[i:i + EXACT_SERVE_ROWS]
              for i in range(0, X.shape[0], EXACT_SERVE_ROWS)]
    means = torch.cat([predict_means_exact(kernel, tr, b) for b in blocks])
    variances = None
    if with_stddev:
        variances = torch.cat([
            predict_variances_exact(kernel, tr, b, predictive=predictive)
            for b in blocks]).cpu().numpy()
    return means.cpu().numpy(), variances


#: test points a CG variance solve takes at a time: the (n, columns) right
#: -hand side and the CG state at 20,000 training rows are 330 MB each in
#: f64
CG_SERVE_COLS = 2048


@torch.no_grad()
def serve_exact_cg(kernel, art, extra, X, *, with_stddev=False,
                   predictive=False):
    """(means, variances or None) of an iterative exact-GP artifact at X
    (on the device): the means k(X, Xtrain) alpha (``predict_means_iter``);
    the variances solved by Nystrom-preconditioned CG at tol 1e-4 against
    the stored training inputs ``cg_x`` (exact variances, not the FITC
    approximation), CG_SERVE_COLS test points a solve, the anchor rows
    drawn by a generator seeded 0."""
    from .models.iterative import (
        IterTrained,
        _anchors,
        nystrom_precond,
        predict_means_iter,
        predict_variances_iter,
    )

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=F64, device=X.device)

    tr = IterTrained(z=t(art.inducing), sigma2=t(art.sigma2),
                     alpha=t(art.coeffs), iters=0, relres=t(0.0))
    means = predict_means_iter(kernel, tr, X).cpu().numpy()
    if not with_stddev:
        return means, None
    x_train = t(extra["cg_x"])
    pre = nystrom_precond(kernel, x_train, tr.sigma2, _anchors(
        x_train, int(extra["cg_anchors"]),
        torch.Generator(X.device).manual_seed(0)))
    variances = torch.cat([
        predict_variances_iter(kernel, tr, x_train, X[i:i + CG_SERVE_COLS],
                               predictive=predictive, precond=pre)[0]
        for i in range(0, X.shape[0], CG_SERVE_COLS)])
    return means, variances.cpu().numpy()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _device()
    try:
        if args.cmd == "train":
            return cmd_train(args, dev)
        return cmd_test(args, dev)
    except FileNotFoundError as e:
        raise SystemExit(f"cannot open model file: {e.filename}")
    except NotImplementedError as e:
        raise SystemExit(str(e))
    except FloatingPointError as e:
        raise SystemExit(
            f"training failed: {e} (check inputs for NaN/inf values)"
        )
    except BrokenPipeError:
        # downstream closed the pipe (e.g. | head) — exit quietly, the
        # POSIX-tool convention
        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        os._exit(0)


if __name__ == "__main__":
    raise SystemExit(main())
