#!/usr/bin/env python3
"""Drive gpr_tpu_torch's streaming serving and training paths, the
README's Quick-start path, bench.py's flagship se_fat leg, the default
streaming route, the base kernel families, the composite families (the
combinators, the ICM task kernel, the spectral mixture), per-row sigma2,
the Gaussian-likelihood extensions (warped, online, PITC, Student-t, exact,
batched tasks), the Laplace likelihood families (logit, Poisson, binomial,
NB2, ordinal), EP and the softmax multi-class Laplace, the iterative exact
GP, the HMC hyper posterior, data-parallel training and serving over
torch.distributed ranks, the 2-D (data x model) mesh and the command-line
trainer/predictor, once on one NVIDIA GPU (the parallel and mesh2d
phases' ranks share it over gloo; with a card for each rank they take
NCCL).

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device  -- the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No GPU: the script raises; there is no CPU path.
2. build   -- nvcc builds csrc/se_iso_stats.cu, csrc/se_iso_bwd.cu and
   csrc/gemm_chain.cu (all three on the product loop of
   csrc/fp32_tile.cuh, the first two sharing csrc/stats_tile.cuh too) for
   sm_90a side by side (gpr_tpu_torch/_build/), with the ptxas register and
   spill report.
3. kernels -- both forward-statistics kernels: ptxas's registers and spills
   of every se_iso_stats_kernel* instantiation (the tiled route's G = 1..6
   and the wide route, each accumulating and plain; a spill fails);
   ``ops.fused_stats._geometry``'s route and shared memory equal to the
   library's for every m in 1..400 at d = 8; then each kernel (f32) against
   the plain PyTorch twin run in f64 on the card, on the same inputs, at
   (65,536, d 8, m 300), at 100,003 rows (ragged) for m = 8, 37, 64, 65,
   129, 200, 300, 383 (every G of the tiled route; 8, 64, 129 and 300 with
   1,000 rows masked), for d = 3 (m = 30) and d = 20 (m = 300, 777 rows
   masked), and for m = 400 (the wide
   route): G and u within 1e-4 relative (Frobenius), the four scalars
   within 1e-5.
4. bwd     -- the backward kernel: ptxas's registers and spills of every
   se_iso_bwd_kernel* instantiation (the tiled route's G = 1..5, where a
   spill fails, and the wide route); ``ops.fused_stats._bwd_geometry``'s
   route and shared memory equal to the library's for every m in 1..400 at
   d = 8; then the kernel (f32) against its twin run in f64 on the card, on
   the same f32 inputs and the real cotangents of the evidence's epilogue,
   at (65,536, m = 300), at 100,003 rows (ragged) for m = 8, 37, 64, 65,
   129, 200, 300, 320 (every G of the tiled route; every other one with
   1,000 rows masked, every third without y_bar), for d = 3 (m = 30) and
   d = 20 (m = 300, which takes the wide route there), and for m = 336 (the
   wide route at d = 8, whose shared memory ends there): z_bar,
   triu(u_inv_bar) and y_bar within 1e-4 relative (Frobenius), the three
   scalar gradients within 1e-4.
5. slice   -- serving: SE-iso at n = 1,000,000, d = 8, m = 300, on the data
   draw of bench.py (np.random.default_rng(0): X, y, Z, cast to f32),
   log_ell 0.5, log_sf2 0, sigma2 0.1, jitter 1e-6, block 8,192.  The f32
   evidence through each kernel must be within 2e-5 relative of the pinned
   f64 truth -2123659.4, the f64 twin within 1 nat; the kernel path's
   coefficients within 1e-3 of the twin's and its 1M predicted means
   finite.  Both forward launch counters must be positive after that run.
   Each forward kernel is then timed at that shape beside its previous
   version's time there (a constant), with its TFLOP/s, its share of the
   bound and the SM clock and power draw nvidia-smi sampled meanwhile.
6. step    -- training: value and gradient (log_ell, log_sf2, z, sigma2) of
   the same evidence through the forward and backward kernels
   (``.backward()``); both counters positive, the evidence within 2e-5
   relative of the truth, each gradient group within 1e-3 relative
   (2-norm) of the f64 twin's on the card.  The backward kernel is then
   timed alone at that shape beside its previous version's time there (a
   constant), with its TFLOP/s, its share of the bound, the bytes of its
   U^-1 cotangent partials read and written back a step (which the bound
   does not count), how many CTAs share a partial and what the partials
   take beside the L2, and the SM clock and power draw sampled meanwhile.
7. fit     -- ``optim.fit`` for 10 L-BFGS iterations on bench.py's training
   recipe (yf = sin(X (0.3 k + 0.2)) + 0.3 noise, the noise drawn here;
   pack from log_ell 0.5, sigma2 1.0; variational): finite, with a mean NLL
   that decreases, through both kernels.
8. roofline -- the GEMM-chain kernel (csrc/gemm_chain.cu, the roofline
   probe's k_chain): ptxas's registers and spills of each instantiation
   (G = 1..6 column groups; a spill fails), its shared memory equal to
   ``ops.gemm_chain._geometry``'s for every m in 1..384; within 1e-5
   relative (Frobenius) of its f64 twin at 65,536 rows for (m, reps) =
   (384, 1), (384, 4), (300, 3) and at 100,003 rows for m = 8, 37, 64, 65,
   129, 200, 300, 384 (every G, ragged tails) with reps 1..4 cycled; then
   the probe's leg-1 shapes (m = 384; 977 x 1,024 rows with reps 1, 488 x
   2,048 rows with reps 1 and 4) and bench.py's ceiling shape (m = 300, 61
   x 16,384 rows, reps 3), each timed with CUDA events beside the previous
   kernel's time there (a constant), its bound and the same chain as
   torch.matmul calls (TF32 off, timed in turns with the kernel; TF32 on
   for information), with the SM clock and power draw nvidia-smi sampled
   meanwhile.
9. restarts -- bench.py's training leg: ``optim.fit_restarts`` over the
   log-lengthscale ladder (-1.5, -0.5, 0.5, 1.5), 12 probe iterations,
   max_iter 60, epsabs 1e-4, rescore_f64 20,000 rows, block 8,192, then
   ``optim.polish`` in f64 on the card (20,000 rows, 30 iterations, epsabs
   1e-3).  Both statistics kernels launched, every
   probe and rescored value finite, the winner's mean NLL below its start,
   the polish's gradient norm below its start.
10. quickstart -- the README's Quick-start path at bench.py's draw (f32,
   block 8,192, the fit phase's targets): (a) ``optim.train`` from log_ell
   0.5, sigma2 1.0, variational, max_iter 10, epsabs 1e-6, through both
   statistics kernels (launched), with at least one accepted iteration,
   finite gradient norms and an evidence no lower than at the start; the
   cost of the host round trip of one evaluation; the same run stopped by
   a Bailout after iteration 5 with a checkpoint and resumed, whose final
   hypers must equal the uninterrupted run's (bit-equal expected; fails
   above 1e-6 relative).  (b) Serving from its result: the nine
   ``calc_stats`` metrics finite with SMSE below 1; ``predict_means`` over
   the 1M rows and ``predict_means_blocked`` each within 1e-5 of the f64
   twin relative to |Knm| |coeffs| (``means_errors``);
   ``predict_variances`` within 1e-4 of ``predict_variances_blocked`` and
   positive; at 2,048 points the diagonals of ``covariances_fic`` and
   ``covariances_fitc`` within 1e-4 of the variances; ``cov_sample`` (512
   draws) and ``sample_fic_blocked`` (1M points x 4 draws) finite; 4,096
   FIC draws at 2,048 points whose mean variance is within 5 % of the
   predicted one.  (c) On the first 20,000 rows: ``fit(objective="loo")``
   (max_iter 10, epsabs 1e-4) raises the LOO pseudo-likelihood;
   ``train_sgd`` and ``train_smd`` (5 steps, eta0 1e-5, each timed twice:
   the first call pays torch.func's set-up) end finite at no less than
   the start evidence; ``choose_n_random_inputs`` picks 300 distinct rows of X and
   ``choose_kmeans_inputs`` (100,000-row subsample, 10 iterations) finite
   centroids.
11. flagship -- bench.py's se_fat leg (bench.py:539-563) on the same draw:
   d = 8, log_sf2 0.1, tproj the fourth draw of bench's default_rng(0) over
   D, hetero noise -5, multiscales 0, Z the projection of X's first 300
   rows, sigma2 0.1, variational, block 16,384.  Value and gradient in f32
   through the plain loop (se_fat has no kernel; no se_iso kernel may
   launch) against its f64 twin on the card: the evidence within 2e-5
   relative, each gradient group (log_sf2, tproj, hetero, multiscales, z,
   sigma2) within 1e-3 (2-norm); then the median of 5 value+grad times with
   the SM clock, the power draw and the peak memory.
12. route -- the default streaming route (impl=None): for every m in
   1..600 at d = 8 and 20, ``ops.fused_stats.default_route`` takes kernels
   #1 and #3 exactly where the library's shared memory of both fits the
   card; then SE-iso f32 value+grad (bench's hypers, jitter 1e-6) through
   ``streaming_log_evidence`` with impl=None at (m = 300, block 8,192) and
   (m = 300, block 1,000), which must launch both kernels, and at m = 400
   (Z = X's first 400 rows), which must launch neither; each within the
   section 2 bounds (evidence 2e-5, gradient groups 1e-3) of the explicit
   impl="reference" in f32; each timed (median of 5).
13. families -- the base families at bench's shape (1M x 8, m = 300, Z the
   family's inducing representation of X's first 300 rows, sigma2 0.1,
   jitter 1e-6, variational, block 16,384, from each family's
   default_params; no kernel may launch).  se_ard, matern32, matern52, rq
   and periodic: f32 value+grad against the f64 twin on the card (evidence
   2e-5, each gradient group 1e-3).  cosine, lin_one, lin_ard and const,
   whose K(Z, Z) has rank 2, d + 1, d and 1: f64 on the card, and the same
   function over the first 100,000 rows on the card and on the CPU
   (evidence and the hyper and sigma2 gradients within 1e-8; the z
   gradient printed).  Each: median of 5 value+grad times, peak memory,
   the SM clock and power draw.
14. composites -- the composite families at bench's shape on the plain
   loop (no kernel may launch; sigma2 0.1, jitter 1e-6): the ICM model
   icm_family(se_iso, 8, 4, 2) of bench.py's ICM leg (its task ids drawn
   after X, y, Z and the se_fat projection, for the rows and for Z; block
   32,768, the FITC evidence), the trend sum(se_iso,lin_ard) (Z = X's
   first 300 rows), sm2 initialized by sm_init_from_data from the first
   100,000 rows, and sm2 from its default_params (the last three
   variational, block 16,384; default_params draw from a generator on the
   card seeded 0).  Each in f32 against its f64 twin on the card (evidence
   2e-5, each gradient group 1e-3; a group whose twin gradient vanishes is
   measured against the whole gradient's norm) but for what f32 cannot
   resolve, which is printed and named in F32_NOT_HELD: trend's lin_ard
   lengthscales (printed again through autograd) and sm_init's sm2 as a
   whole; the ICM z gradient's task column exactly 0 in both.  Then each
   in f64 on the card against the CPU over the first 100,000 rows
   (evidence 1e-8, each group within max(1e-8, eps kappa), kappa the
   condition number of K(Z, Z) + jitter I; sm_init's sm2's z gradient
   printed, F64_NOT_HELD).  Each: the median of 5 f32
   value+grad times, peak memory, the SM clock and power draw.
15. hetero -- SE-iso f32 value+grad with per-row sigma2 0.1 (1 + 0.5 u), u
   ~ U(0, 1) from default_rng(1), every 100th row masked (10,000), through
   ``stream_stats`` (the plain loop under autograd, block 16,384) against
   its f64 twin (evidence 2e-5, each gradient group, the sigma2 vector's
   too, 1e-3; masked rows get no sigma2 gradient), no kernel launched;
   the median of 5 times and the peak memory.
16. gaussian_ext -- the Gaussian-likelihood extensions on the same draw
   (SE-iso at log_ell 0.5, sigma2 0.1, jitter 1e-6), each against its f64
   twin within the section 2 bounds (evidence 2e-5, each gradient group
   1e-3): the warped evidence (the K = 3 default warp, block 8,192,
   impl=None) must launch #1 and #3 once each and is held against the f32
   plain loop too, the warp's gradient group included; 5 iterations of
   ``fit_warped`` (as many #1 as #3 launches) and the warped moments at the
   1M points; online updates of 10 batches of 100,000 rows (one #1 launch
   each) and a downdate of the last, against the streaming evidence (2e-5)
   and coefficients (1e-3) of the 900,000 rows left; PITC at block 256;
   bench.py's student-t leg (one dense E-step sweep, the dense M-step with
   noise 0.1 / lam) and ``fit_t(block_size=16384, n_em=2,
   m_step_iters=3)``, whose lam_hat must lie in (0, (nu+1)/nu]; the exact
   GP on the first 20,000 rows in f64 (evidence and LOO with gradients,
   finite; Titsias' bound below the exact evidence and rising for Z = the
   first 100, 300, 1,000, 3,000 rows; 100,000 means and positive
   variances, and mu(X) = y - sigma2 alpha within 1e-8); 4 tasks sharing X
   (bench's y and three draws of default_rng(4)) through
   ``batched_value_and_grad``: streaming, 4 launches each of #1 and #3,
   each task against its own f32 loop and f64 twin, and dense (vmap) at
   100,000 rows against each task's f64 twin.  Times: median of 3.
17. laplace -- the Laplace likelihood families (no kernel; none may
   launch) on the same draw, SE-iso at bench's hypers, jitter 1e-6, 15
   Newton steps: bench.py's classify leg (labels sign(y) + (y == 0)),
   value and gradient (log_ell, log_sf2, z) dense and streaming at block
   8,192 over the 1M rows, each in f32 against its f64 twin on the card
   (the section 2 bounds: evidence 2e-5, each gradient group 1e-3),
   timed (the streaming legs once after a warm-up), with its bound
   (``classify_bound``) and peak memory; Poisson,
   binomial (1..5 trials) and NB2 (r = 2, its gradient included) counts
   drawn from default_rng(5) over the latent sin(x0 + x1), and bench's
   ordinal leg (K = 4, labels digitize(x0 + x1, [-1, 0, 1]), cut_raw
   [-1, 0, 0] and its gradient), dense at 1M and streaming at 100,000
   rows, the same way, but for what f32 cannot resolve
   (LAPLACE_F32_NOT_HELD), held in f64 card vs CPU over 100,000 rows
   (1e-8); the IFT against the unrolled gradient in f64 at 100,000 rows,
   dense and streaming, logit and ordinal (evidence 1e-9, groups 1e-6);
   fit_classify, fit_poisson and fit_ordinal, 5 iterations in f32 at
   100,000 rows (curvature window 0.9), whose mean NLL must fall;
   classify_predict against
   stream_classify_predict at 100,000 points (probabilities in (0, 1),
   within 1e-5).
18. classify_ext -- EP and the softmax Laplace (no kernel; none may
   launch) on the same draw, SE-iso at bench's hypers, jitter 1e-6:
   bench.py's EP leg (labels sign(y) + (y == 0), 20 sweeps, "stationary")
   dense at 1M, the trace of its sweeps printed, and bench.py's
   multi-class leg (labels digitize(x0 + x1, [-0.8, 0.8]), C = 3, 8 Newton
   steps, "ift") dense at 1M and streaming at 100,000 rows (block 8,192),
   each value and gradient (log_ell, log_sf2, z) in f32 against its f64
   twin on the card (evidence 2e-5, each group 1e-3, but for
   CLASSIFY_EXT_F32_NOT_HELD, held in f64 card vs CPU over 100,000 rows,
   1e-8), timed beside its bound (``ep_bound``, ``multi_bound``) with its
   peak memory, and for information EP with its sweeps and evidence in f64
   on the f32 V and the multi-class leg all in f32 (the JAX package's
   dtypes); the gradient routes in f64 at 100,000 rows (EP stationary
   vs unroll, multi-class IFT vs unroll, streaming vs dense: evidence
   1e-9, groups 1e-6, with the sites and the mode converged, 40 sweeps and
   20 steps; at bench's counts printed); fit_classify_ep and
   fit_classify_multi dense and streaming, 5 iterations in f32 at 100,000
   rows, whose mean NLL must fall; ep_predict against the
   ep_posterior_state route at 100,000 points (means 1e-5, variances and
   probabilities 1e-4); the dense multi-class state against the streamed
   one, served at 100,000 points (mu, Sigma, the Monte Carlo probabilities
   of one generator seed within 1e-5 of the largest entry, each row
   summing to 1); the dense state at 1M rows, timed once with its peak.
19. iterative -- the iterative exact GP (no kernel; none may launch) on
   probes/r5_iterative_tpu.py's problem over bench's rows: X[:100,000], y =
   sin(sum x) + 0.1 N(0, 1) from default_rng(1), SE-iso log_ell 1, log_sf2
   0, sigma2 0.1, f32, 1,024 anchor rows, block 8,192: ``kernel_matvec``
   at 1 and 9 columns against its f64 twin on the card (1e-5 relative),
   timed beside ``matvec_bound``; the alpha solve at tol 1e-3 (400
   iterations at most; its true relres <= 1e-3, peak memory); 256
   variances at tol 1e-4 with the anchors' preconditioner; the SGD step
   (``evidence_grads_iter`` with 8 probes at tol 1e-3, then
   ``sgd_update``), its peak held under ITER_PEAK_GIB; then in f64 at
   20,000 rows CG's alpha, means and variances against the dense
   ``models/exact.py`` (10 x tol 1e-8) and the 4-seed mean of
   ``evidence_grads_iter`` within 10 % of the exact autograd gradient.
20. hmc -- bench.py's HMC leg (bench.py:804-852) through
   ``sample_posterior``: 100,000 rows of the draw, SE-iso at bench's hypers,
   Z fixed (m = 300), sigma2 learned, variational, dense, 8 leapfrog steps,
   60 warmup and 20 samples, 1 chain, jitter 0.05, init step 0.02, under
   bench's session precision "high" (TF32 forces): the first call, then ms
   a leapfrog, min-ESS/s and the accept rate, which must lie in [0.65,
   0.9] with the accept energy that ships (f32 at "highest"); the same with
   no accept energy, with it in f64, and with full-f32 forces, for
   information; 20 transitions on the streaming route (block 8,192), where
   #3 must launch once a force and #1 once a force and once an accept
   energy; the mixture predictive of those draws at 1,000 points, finite
   and no narrower than the narrowest single draw.
21. parallel -- ``gpr_tpu_torch/parallel/`` at bench's full width (the
   step's draw and model, f32, block 8,192): (a) a one-rank world (NCCL)
   whose sharded evidence and gradient equal streaming_log_evidence's on
   the same card within 1e-6 relative; then PAR_RANKS = 2 ranks (gloo on
   the one card, the backend and the rank-to-card map printed), against
   the single-device path computed first in this process: (b) the step's
   value within 2e-5 and each gradient group within 1e-3 relative, #1 and
   #3 launched exactly once in each rank for one evaluation (counted in
   the ranks), ms per evaluation beside one rank's with the SM clock and
   power, the time of one all-reduce of the m^2 + m + 4 statistics, and
   ``fit_sharded`` for 5 iterations, x bit-equal on the ranks, beside
   ``fit``'s mean NLL; (c) the TSQR evidence within 2e-5 of the Gram one;
   (d) the sharded predictors' 1M means and variances within 1e-5 of the
   single-device ones; (e) the binary Laplace at 1M rows (bench's classify
   labels, 15 Newton steps) within 2e-5 / 1e-3; (f) ``sharded_iter_solve``
   over the iterative phase's problem (tol 1e-3, its true relres <= 1e-3,
   alpha within 1e-2 of the single-device solve's), and whether the ring's
   send/recv staged through the host.
22. mesh2d -- ``parallel/mesh2d.py`` and ``dist_chol.py`` at bench's full
   width on a 2x2 mesh of MESH2D_RANKS = 4 gloo ranks sharing the card
   (bench's draw and model, f32, block 8,192), against the single-device
   path computed first in this process: (a) value and gradient of
   ``sharded_log_evidence_2d`` with the replicated epilogue, the
   distributed epilogue and the fully distributed inducing state
   (whitened), each within 2e-5 (evidence) and 1e-3 (each gradient group)
   of ``streaming_log_evidence``'s step but what MESH2D_F32_NOT_HELD
   names (the fully distributed mode's z gradient), ms an evaluation with
   the SM clock and power; (b) the f64 modes (replicated and distributed
   epilogue on the raw Gram, the fully distributed raw and whitened
   factorizations) on bench's first 100,000 rows within 1e-8 of the
   single-device f64 step on the card; (c) ``fit_sharded_2d`` for 5
   iterations, x bit-equal on the four ranks, its mean NLL within 1e-4 of
   ``fit``'s; (d) ``fully_distributed_predict`` conditioned on and serving
   the 1M rows, in f64 and f32 (its means not held), against
   ``predict_means_blocked`` (1e-5 of the 2-norm of |Knm| |coeffs|) and
   ``predict_variances_blocked`` (1e-4); (e) #1-#4
   launched 0 times in every rank over (a) and (c); and the collectives
   staged through the host.  (f), the CLI's -trainer sharded -devices 2x2,
   runs beside the cli phase's trainings (below).
23. cli -- ``python3 -m gpr_tpu_torch.cli`` in subprocesses on CSVs of
   bench's draw (the first 200,000 rows of X with the fit phase's targets;
   rows 200,000-299,999 to test on), se_fat with -n-inducing 300 -dim-red 8
   -log-het-sked -5 -multiscale -inducing-init first -seed 0: (a) the host
   trainer, -max-iter 5; (b) -trainer device -block-size 16384, -max-iter 5,
   and the same stopped by -max-iter 2 with -checkpoint and resumed to 5,
   whose hypers must equal the uninterrupted run's (bit-equal expected;
   fails above 1e-6 relative); (c) -cmd test -with-stddev with the host and
   the resumed artifact: 100,000 finite lines whose means equal, as
   printed, the library's predict_means on the loaded artifact; (d)
   -kernel matern52 -n-inducing 300 -inducing-init first -seed 0 with the
   device trainer at block 16,384, -max-iter 5, and -cmd test
   -with-stddev of its artifact, checked as in (c); (e) the same with
   -kernel sm2 (its keyless init from the training rows' spectrum); (f)
   -kernel se_iso -tasks 4 -coreg-rank 2 on the same rows with bench's
   ICM task ids as a last input column (and on its test rows), whose
   -verbose stderr must print a finite 4 x 4 B; (g) -kernel se_iso
   -n-inducing 300 with -trainer device and -pitc-block 256, -warp 3 or
   -student-t 4, and -exact and -exact -loo on the first 20,000 rows, each
   served by -cmd test -with-stddev as in (c) (a warped model's means are
   the library's warped_predict_moments, an exact one's its dense
   posterior); (h) the Laplace modes -classify, -classify -block-size
   16384, -poisson, -binomial, -negbin 2 and -ordinal (-kernel se_iso
   -n-inducing 300 -trainer device -max-iter 2) on the same rows with the
   laplace phase's targets (-classify: yf > 0 of the fit phase's), and
   -classify -approx ep (the same labels) and -classify on bench's
   multi-class labels, dense and -block-size 16384; (i) -exact -cg
   -n-inducing 64 -max-iter 5 on the first EXACT_ROWS rows, whose -cmd
   test prints the CLI_TEST means and, with -with-stddev, the first
   CLI_CG_STDDEV rows' CG standard deviations, every mean equal, as
   printed, to the library's predict_means_iter on the artifact; (j)
   -trainer sharded -devices 2 -max-iter 5 and (the mesh2d phase's (f))
   -devices 2x2 -max-iter 2, -block-size 16384 with (b)'s other flags,
   whose hypers must lie within 1e-6 relative of (b)'s uninterrupted run's
   and of its checkpointed -max-iter 2 run's, and the 2x2 artifact served
   as in (c).  The Laplace tests print 100,000 finite lines each, every
   line but its stddev column (multi-class: every whole line) equal, as
   printed, to the library's latent posterior on the artifact through the
   model's link (EP's exact probit predictive; multi-class:
   multiclass_predict_from_state with a generator seeded 0, and the
   latent stddevs) (``library_laplace``).  The processes run in four
   waves side by side on the card: (a) and (b)'s two first trainings;
   then, after one -cmd test on one row alone (what every command pays to
   start), the resumed training with (d)-(g), (i) and (j); then (h); then
   every test.
   Each command's wall time, iterations and evaluations (the device
   trainer prints them), the log evidence (recomputed here in f64) and
   SMSE, and which CSV parser ran.
Timings: median of 5 after a warm-up, host clock around synchronised
calls, or CUDA events where named (the chain and its torch.matmul
yardstick: median of 10, in two turns each); one run for the trainers.

A ``phase seconds:`` line gives each phase's wall time.  The line before
the last is a JSON object of the kernels (each with its
bound: the larger of its flops at the 67 TFLOP/s FP32 peak and its bytes,
each input read and each output written once, at 3.35 TB/s); the last line
is ``{"ok": true, "device": {...}}``.  Any failed check raises (exit code
1).
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from gpr_tpu_torch import cli
from gpr_tpu_torch.config import config
from gpr_tpu_torch.convert import (
    from_jax_params,
    params_from_artifact,
    warp_from_jax,
)
from gpr_tpu_torch.io import load_model, native
from gpr_tpu_torch.kernels import (
    FAMILIES,
    SeFat,
    SeIso,
    icm_family,
    resolve_family,
    sm_init_from_data,
)
from gpr_tpu_torch.kernels.base import hyper_fields, hyper_leaves, static_fields
from gpr_tpu_torch.models import ift, iterative, streaming
from gpr_tpu_torch.models.fitc import calc_inducing
from gpr_tpu_torch.numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    solve_tri_right,
)
from gpr_tpu_torch.ops import _build, fused_stats
from gpr_tpu_torch.ops.gemm_chain import (
    MAX_M,
    _gemm_chain_reference,
    _geometry,
    gemm_chain,
)
from gpr_tpu_torch.models import (
    calc_stats,
    choose_kmeans_inputs,
    choose_n_random_inputs,
    co_variance_predictor,
    CoVariancePredictor,
    cov_sample,
    cov_sampler,
    covariances_fic,
    covariances_fitc,
    log_evidence,
    loo_objective_fitc,
    MeanPredictor,
    mean_predictor,
    predict_means,
    predict_variances,
    sample_fic_blocked,
)
from gpr_tpu_torch.models.binomial import binomial_log_evidence
from gpr_tpu_torch.models.classify import (
    _fitc_prior,
    classify_log_evidence,
    prior_up,
    classify_predict,
    fit_classify,
    mackay_squash,
)
from gpr_tpu_torch.models.classify_ep import (
    ep_log_evidence,
    ep_log_evidence_from_sites,
    ep_posterior_state,
    ep_predict,
    ep_sweeps,
    fit_classify_ep,
)
from gpr_tpu_torch.models.classify_multi import (
    fit_classify_multi,
    multiclass_log_evidence,
    multiclass_posterior_state,
    multiclass_predict_from_state,
)
from gpr_tpu_torch.models.classify_multi_stream import (
    stream_multiclass_log_evidence,
    stream_multiclass_state,
)
from gpr_tpu_torch.models.classify_stream import stream_classify_predict
from gpr_tpu_torch.models.exact import (
    calc_exact,
    exact_trained,
    log_evidence_exact,
    loo_objective_exact,
    predict_means_exact,
    predict_variances_exact,
)
from gpr_tpu_torch.models.multitask import batched_value_and_grad
from gpr_tpu_torch.models.negbin import negbin_log_evidence
from gpr_tpu_torch.models.ordinal import (
    cell_probs,
    fit_ordinal,
    ordinal_log_evidence,
)
from gpr_tpu_torch.models.poisson import fit_poisson, poisson_log_evidence
from gpr_tpu_torch.models.online import (
    online_downdate,
    online_init,
    online_log_evidence,
    online_predictors,
    online_update,
)
from gpr_tpu_torch.models.pitc import pitc_log_evidence
from gpr_tpu_torch.models.robust import fit_t, t_em_sweeps
from gpr_tpu_torch.models.warped import (
    WARP_FIELDS,
    default_warp_params,
    fit_warped,
    make_warped_pack,
    warp,
    warp_inv,
    warped_log_evidence,
    warped_predict_moments,
)
from gpr_tpu_torch.parallel import (
    fit_sharded,
    fit_sharded_2d,
    fully_distributed_predict,
    make_mesh_2d,
    run_spmd,
    shard_batch,
    sharded_classify_log_evidence,
    sharded_grad,
    sharded_iter_solve,
    sharded_log_evidence,
    sharded_log_evidence_2d,
    sharded_log_evidence_tsqr,
    sharded_predict_means,
    sharded_predict_variances,
    sharded_value_and_grad,
)
from gpr_tpu_torch.parallel.spmd import choose_backend
from gpr_tpu_torch.optim import (
    Bailout,
    fit,
    fit_restarts,
    hmc,
    make_accept_energy,
    make_objective,
    make_pack,
    polish,
    predict_hmc_mixture,
    sample_posterior,
    train,
    train_sgd,
    train_smd,
    value_and_grad,
)

N, D, M = 1_000_000, 8, 300
LOG_ELL, LOG_SF2, SIGMA2, JITTER = 0.5, 0.0, 0.1, 1e-6
TRUTH = -2123659.4  # bench.py's f64 evidence for exactly this draw
BLOCK = 8192
SOURCE = "gpr_tpu_torch/csrc/se_iso_stats.cu"
BWD_SOURCE = "gpr_tpu_torch/csrc/se_iso_bwd.cu"
KERNELS = {  # forward wrapper -> the Pallas body it replaces
    "se_iso_stream_stats_fused_acc": "gpr_tpu/ops/fused_stats.py:121",
    "se_iso_stream_stats_fused": "gpr_tpu/ops/fused_stats.py:79",
}
BWD_KERNEL = "se_iso_stream_bwd_fused"
BWD_REPLACES = "gpr_tpu/ops/fused_stats.py:341"
CHAIN_SOURCE = "gpr_tpu_torch/csrc/gemm_chain.cu"
CHAIN_REPLACES = "probes/r3_roofline_probe.py:98"
# The previous chain kernel (a 32-row tile, 4 rows a warp, one column pair
# of a 64-column W panel a lane) at the timed shapes, (n, m, reps) -> ms:
# CUDA events, median of 5, NVIDIA H100 80GB HBM3 at 700.00 W.
PREV_CHAIN_MS = {(977 * 1024, 384, 1): 25.16, (488 * 2048, 384, 1): 25.20,
                 (488 * 2048, 384, 4): 91.57, (61 * 16_384, 300, 3): 47.44}
# The previous forward kernel (V in place from 32-column panels staged
# without prefetch; one CTA per 8,192 rows) at 1M x 8, m = 300: host clock,
# median of 5, NVIDIA H100 80GB HBM3 at 700.00 W.
PREV_STATS_MS = {"se_iso_stream_stats_fused_acc": 22.27,
                 "se_iso_stream_stats_fused": 17.68}
# The previous backward kernel (32-row tiles, each product's 64-column
# panels staged without prefetch, one CTA per 8,192 rows) at 1M x 8, m = 300:
# host clock, median of 5, NVIDIA H100 80GB HBM3 at 700.00 W.
PREV_BWD_MS = 78.13
# (n, d, m, rows masked) of the kernels phase: every G of the tiled route at
# ragged n, two other d, and the wide route.  At d = 3 the m is small: 100
# standard-normal inducing points in 3 dimensions give K(Z, Z) a condition
# number near 5e6, and then even the f32 twin's u lies 8e-5 from the f64
# twin's (m = 30: 1e5, and 4e-6).
# The wide route at m = 400 (64-row tiles), 1,000 (48), 1,200 (32), and at
# d = 20 2,000 (24), 3,000 (16) and 4,000 (8): at d = 8 and m = 4,000 even
# the f32 twin's u lies 1.4e-4 from the f64 twin's (3,000 rows on the CPU),
# and at d = 20 and m = 3,000 the f32 twin's sum log s 1.2e-5 (on the card),
# past the 1e-5 bound: check_errors then holds the kernel to twice the
# twin's error.
KERNEL_CASES = (
    (65_536, D, 300, 0), (100_003, D, 37, 1_000),
    *((100_003, D, m, 1_000 * (1 - i % 2))
      for i, m in enumerate((8, 37, 64, 65, 129, 200, 300, 383))),
    (100_003, 3, 30, 0), (100_003, 20, 300, 777), (100_003, D, 400, 1_000),
    (100_003, D, 1_000, 1_000), (65_536, D, 1_200, 0), (65_536, 20, 2_000, 0),
    (20_011, 20, 3_000, 0), (20_011, 20, 4_000, 11),
)
# (n, d, m, rows masked, need_y) of the bwd phase: every G of the tiled
# route at ragged n, two other d (d = 20 at m = 300 takes the wide route),
# and the wide route at 32-row tiles (m = 336 and 400), and at d = 20 24
# (1,000), 16 (1,200) and 8 (1,900): at d = 8 and m = 1,000 even the f32
# twin's z-bar lies 2.3e-3 from the f64 twin's (20,000 rows on the CPU).
BWD_CASES = (
    (65_536, D, 300, 0, True), (100_003, D, 37, 1_000, True),
    *((100_003, D, m, 1_000 * (i % 2), i % 3 != 2)
      for i, m in enumerate((8, 37, 64, 65, 129, 200, 300, 320))),
    (100_003, 3, 30, 0, True), (100_003, 20, 300, 777, True),
    (100_003, D, 336, 1_000, True), (100_003, D, 400, 1_000, True),
    (65_536, 20, 1_000, 0, True), (30_011, 20, 1_200, 0, True),
    (20_011, 20, 1_900, 11, False),
)
# m of the geometry checks beyond 1..1200: each wide route's last m at
# d = 8 for each rows a tile, and the first m past it
FWD_EDGES = (1_623, 1_624, 2_143, 2_144, 3_159, 3_160, 5_983, 5_984)
BWD_EDGES = (1_520, 1_521, 2_880, 2_881)
WRAPPERS = {  # every launch-counted wrapper, by name
    **{name: getattr(fused_stats, name) for name in (*KERNELS, BWD_KERNEL)},
    "gemm_chain": gemm_chain,
}
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores (H100 SXM data sheet)
HBM = 3.35e12  # bytes/s
LADDER = (-1.5, -0.5, 0.5, 1.5)  # bench.py's fit_restarts ladder
FIELDS = ("G", "u", "sum_log_s", "y_is_y", "is_r", "n_live")
BWD_FIELDS = ("log_ell", "log_sf2", "z", "u_inv", "sigma2", "y")


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi.splitlines()[0]


def build_phase() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    path = _build.library_path()
    log(f"build: {secs:.1f} s -> {path.name}")
    build_log = path.with_suffix(".log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if any(k in line for k in ("Function properties", "registers",
                                       "spill")):
                log(f"  ptxas: {line.strip()}")


def rel_errors(got, want):
    """Per-output relative errors (Frobenius for G and u)."""
    return {
        name: float(torch.linalg.norm(g.double() - w.double())
                    / torch.linalg.norm(w.double()))
        for name, g, w in zip(FIELDS, got, want)
    }


def stats_bounds(errs) -> dict:
    """The kernels phase's bounds: G and u within 1e-4, the scalars 1e-5."""
    return {name: 1e-4 if name in ("G", "u") else 1e-5 for name in errs}


def check_errors(tag, errs, twin_errs=None):
    """Each error within its bound or, where the f32 twin's error on the
    same inputs (``twin_errs``) misses that bound too, within twice the
    twin's: f32 itself cannot do better there."""
    log(f"  {tag}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + ("" if twin_errs is None else "; the f32 twin's: " + ", ".join(
            f"{k} {v:.2e}" for k, v in twin_errs.items())))
    for name, bound in stats_bounds(errs).items():
        if twin_errs is not None:
            bound = max(bound, 2 * twin_errs[name])
        if not errs[name] <= bound:
            raise AssertionError(f"{tag}: {name} rel err {errs[name]:.3e} "
                                 f"> {bound:.3e}")


def stats_inputs(kernel, z, sigma2, X, y, jitter=None):
    """Positional inputs of the ops wrappers for one problem."""
    inducing = calc_inducing(kernel, z, jitter)
    return (kernel.log_ell.detach(), kernel.log_sf2.detach(), z,
            inv_tri_upper(inducing.chol_km).contiguous(), sigma2, X, y)


def as_f64(args):
    return [None if a is None else a.double() for a in args]


def ptxas_report(pattern) -> dict:
    """{label: (registers, spill store bytes, spill load bytes)} of each
    kernel whose mangled name matches ``pattern`` in this run's build log
    (label: the pattern's groups); empty if the library was not built in
    this run."""
    build_log = _build.library_path().with_suffix(".log")
    if not build_log.exists():
        return {}
    found, key = {}, None
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            hit = re.search(pattern, line)
            key = hit.groups() if hit else None
        elif key is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            found[key] = [None, int(st), int(ld)]
        elif key is not None and "registers" in line and key in found:
            found[key][0] = int(re.search(r"Used (\d+) registers",
                                          line).group(1))
            key = None
    return {k: tuple(v) for k, v in sorted(found.items(), key=str)}


def stats_ptxas() -> None:
    """Registers and spills of every se_iso_stats_kernel* instantiation:
    the tiled route's G = 1..6 and the wide route's R = 64, 48, 32, 24, 16
    and 8 rows a tile, each with kComp true (se_iso_stats_acc) and false
    (se_iso_stats_partials)."""
    report = ptxas_report(r"se_iso_stats_kernel(_wide)?I(?:Li(\d+)E)?Lb(\d)E")
    names = {(w, g, c): (f"wide R={g}" if w else f"G={g}")
             + (" acc" if c == "1" else " partials") for w, g, c in report}
    log("se_iso_stats ptxas: " + ("; ".join(
        f"{names[k]}: {r} registers, spill {st}/{ld} bytes"
        for k, (r, st, ld) in report.items()) or "not built in this run"))
    if report and (len(report) != 24 or any(
            st or ld for _, st, ld in report.values())):
        raise AssertionError(f"se_iso_stats instantiations spill or are "
                             f"missing: {report}")


def kernels_phase(dev) -> None:
    stats_ptxas()
    lib = _build.load_library()
    for m in (*range(1, 1_201), *FWD_EDGES):
        geo = fused_stats._geometry(1, m, D, 132)
        groups = lib.se_iso_stats_groups(m, D)
        lib_geo = (groups, lib.se_iso_stats_smem_bytes(m, D),
                   64 if groups else lib.se_iso_stats_wide_rows(m, D))
        if (geo.groups, geo.smem_bytes, geo.rows) != lib_geo:
            raise AssertionError(f"m={m}: _geometry's (G, shared memory, "
                                 f"rows) {geo.groups, geo.smem_bytes, geo.rows}"
                                 f" differ from the library's {lib_geo}")
    rng = np.random.default_rng(1)
    params = {"log_ell": np.float32(LOG_ELL), "log_sf2": np.float32(LOG_SF2)}
    for n, d, m, masked in KERNEL_CASES:
        X = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                            device=dev)
        y = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev)
        Z = rng.standard_normal((m, d)).astype(np.float32)
        mask = None
        if masked:
            mask = torch.ones(n, dtype=torch.float32, device=dev)
            mask[-masked:] = 0.0
        with torch.no_grad():
            kernel, z, s2 = from_jax_params(params, Z, np.float32(SIGMA2),
                                            device=dev, dtype=torch.float32)
            args = [*stats_inputs(kernel, z, s2, X, y), mask]
            want = fused_stats._se_iso_stats_reference(
                *as_f64(args), block_size=BLOCK, acc_dtype=torch.float64)
            if int(want[-1]) != n - masked:
                raise AssertionError(f"twin counted {int(want[-1])} rows")
            geo = fused_stats._geometry(n, m, d, 1)
            route = f"G={geo.groups}" if geo.groups else f"wide R={geo.rows}"
            twin_errs = None
            for name in KERNELS:
                got = getattr(fused_stats, name)(
                    *args, block_size=BLOCK, acc_dtype=torch.float64)
                torch.cuda.synchronize()
                errs = rel_errors(got, want)
                if twin_errs is None and any(
                        errs[k] > b for k, b in stats_bounds(errs).items()):
                    twin_errs = rel_errors(
                        fused_stats._se_iso_stats_reference(
                            *args, block_size=BLOCK, acc_dtype=torch.float64),
                        want)
                check_errors(f"kernels n={n} d={d} m={m} {route} "
                             f"masked={masked} {name}", errs, twin_errs)


def epilogue_cotangents(kernel64, z64, stats):
    """The real cotangents of the evidence's epilogue at ``stats`` (f64;
    variational, so all five are nonzero)."""
    with torch.no_grad():
        inducing = calc_inducing(kernel64, z64, JITTER)
    leaves = [s.detach().double().requires_grad_(True) for s in stats[:5]]
    value = streaming.evidence_from_stats(
        inducing, streaming.StreamStats(*leaves, stats[5].double()),
        variational=True)
    return torch.autograd.grad(value, leaves)


def bwd_errors(got, want):
    """Relative errors of the backward outputs (Frobenius for z, u_inv and
    y); the kernel returns only the upper triangle of u_inv_bar."""
    errs = {}
    for name, g, w in zip(BWD_FIELDS, got, want):
        if g is None:
            continue
        if name == "u_inv":
            g, w = g.triu(), w.triu()
        errs[name] = float(torch.linalg.norm(g.double() - w.double())
                           / torch.linalg.norm(w.double()))
    return errs


def check_bwd(tag, errs):
    log(f"  {tag}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    for name, err in errs.items():
        if not err <= 1e-4:
            raise AssertionError(f"{tag}: {name} rel err {err:.3e} > 1e-4")


def bwd_ptxas() -> None:
    """Registers and spills of every se_iso_bwd_kernel* instantiation: the
    tiled route's G = 1..5, which must not spill, and the wide route's
    R = 32, 24, 16 and 8 rows a tile."""
    report = ptxas_report(r"se_iso_bwd_kernel(_wide)?(?:ILi(\d+)E)?")
    log("se_iso_bwd ptxas: " + ("; ".join(
        (f"wide R={g}" if w else f"G={g}") + f": {r} registers, spill "
        f"{st}/{ld} bytes" for (w, g), (r, st, ld) in report.items())
        or "not built in this run"))
    if report and (len(report) != 9 or any(
            st or ld for (w, _), (_, st, ld) in report.items() if not w)):
        raise AssertionError(f"se_iso_bwd instantiations spill or are "
                             f"missing: {report}")


def bwd_phase(dev) -> None:
    bwd_ptxas()
    lib = _build.load_library()
    for m in (*range(1, 1_201), *BWD_EDGES):
        geo = fused_stats._bwd_geometry(1, m, D, 132)
        groups = lib.se_iso_bwd_groups(m, D)
        lib_geo = (groups, lib.se_iso_bwd_smem_bytes(m, D),
                   64 if groups else lib.se_iso_bwd_wide_rows(m, D))
        if (geo.groups, geo.smem_bytes, geo.rows) != lib_geo:
            raise AssertionError(f"m={m}: _bwd_geometry's (G, shared memory, "
                                 f"rows) {geo.groups, geo.smem_bytes, geo.rows}"
                                 f" differ from the library's {lib_geo}")
    rng = np.random.default_rng(2)
    params = {"log_ell": np.float32(LOG_ELL), "log_sf2": np.float32(LOG_SF2)}
    for n, d, m, masked, need_y in BWD_CASES:
        X = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                            device=dev)
        y = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev)
        Z = rng.standard_normal((m, d)).astype(np.float32)
        mask = None
        if masked:
            mask = torch.ones(n, dtype=torch.float32, device=dev)
            mask[-masked:] = 0.0
        with torch.no_grad():
            kernel, z, s2 = from_jax_params(params, Z, np.float32(SIGMA2),
                                            device=dev, dtype=torch.float32)
            args = [*stats_inputs(kernel, z, s2, X, y), mask]
            stats = fused_stats._se_iso_stats_reference(
                *as_f64(args), block_size=BLOCK, acc_dtype=torch.float64)
        k64, z64, _ = from_jax_params(params, Z, np.float32(SIGMA2),
                                      device=dev, dtype=torch.float64)
        cot32 = [c.float() for c in epilogue_cotangents(k64, z64, stats)]
        with torch.no_grad():
            got = fused_stats.se_iso_stream_bwd_fused(
                *args, *cot32, block_size=BLOCK, acc_dtype=torch.float64,
                need_y=need_y)
            torch.cuda.synchronize()
            want = fused_stats._se_iso_bwd_reference(
                *as_f64(args), *as_f64(cot32), block_size=BLOCK,
                acc_dtype=torch.float64, need_y=need_y)
        if (got[-1] is None) == need_y:
            raise AssertionError(f"need_y={need_y} but y_bar is {got[-1]}")
        geo = fused_stats._bwd_geometry(n, m, d, 1)
        check_bwd(f"bwd n={n} d={d} m={m} "
                  + (f"G={geo.groups}" if geo.groups else f"wide R={geo.rows}")
                  + f" masked={masked} need_y={need_y}",
                  bwd_errors(got, want))


def median_ms(fn, reps=5) -> float:
    """Host clock around synchronised calls: median of ``reps`` after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def event_times(fn, reps=5) -> list[float]:
    """CUDA events around each of ``reps`` calls after one warm-up, in ms."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def clock_log() -> subprocess.Popen:
    """Start nvidia-smi sampling the SM clock and the power draw every 100
    ms; stop it with read_clock_log."""
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def read_clock_log(proc: subprocess.Popen) -> list[tuple]:
    """Stop the sampler; its samples as (unix time, SM MHz, W)."""
    proc.terminate()
    out = proc.communicate(timeout=60)[0]
    samples = []
    for line in out.splitlines():
        try:
            stamp, mhz, watts = (f.strip() for f in line.split(","))
            samples.append((datetime.strptime(
                stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp(), int(mhz),
                float(watts)))
        except ValueError:
            continue
    return samples


def clock_window(samples, t0, t1) -> str:
    """The SM clock range and the peak power among the samples in [t0,
    t1]."""
    window = [(mhz, watts) for t, mhz, watts in samples if t0 <= t <= t1]
    if not window:
        return "clock not sampled"
    return (f"SM clock {min(c for c, _ in window)}-"
            f"{max(c for c, _ in window)} MHz, power up to "
            f"{max(p for _, p in window):.0f} W")


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the flops at the
    FP32 peak and the bytes at the HBM rate."""
    t_ops, t_bytes = 1e3 * flops / PEAK_FP32, 1e3 * nbytes / HBM
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def stats_bound(n, d, m) -> dict:
    """Forward statistics over n live rows: per row m d (x z'), m (m + 1)/2
    (V against the upper-triangular U^-1), m (m + 1)/2 (the symmetric Gram)
    and m (u) FMAs; X, y, z and U^-1 read, G, u and 4 scalars written."""
    fma = n * (m * d + m * (m + 1) + m)
    return bound(2.0 * fma, 4.0 * (n * (d + 1) + m * d + 2 * m * m + m + 4))


def bwd_bound(n, d, m) -> dict:
    """The backward tile over n rows: per row m d (Knm), m (m + 1)/2 (V),
    m^2 (VG), m (m + 1)/2 (Kb against U^-T), m (m + 1)/2 (the upper
    triangle of Knm' Vb) and m (d + 2) (the pullback) FMAs; X, y, z, U^-1,
    U^-T, UG and u-bar read, z-bar, U^-1-bar and 3 scalars written."""
    fma = n * (m * d + 3 * m * (m + 1) // 2 + m * m + m * (d + 2))
    return bound(2.0 * fma, 4.0 * (n * (d + 1) + 2 * m * d + 4 * m * m + m
                                   + 3))


def chain_bound(n, m, reps) -> dict:
    """x W^reps: 2 n m^2 reps flops; x and W read, out written."""
    return bound(2.0 * n * m * m * reps, 4.0 * (2 * n * m + m * m))


def counted(tag, fn, must_launch):
    """Run one main path with every launch counter set to 0 just before it;
    return (fn's result, the counts read just after).  Fails unless each
    kernel in ``must_launch`` launched."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    log(f"{tag} launches: {launches}")
    missing = [name for name in must_launch if not launches[name] > 0]
    if missing:
        raise AssertionError(f"{tag}: a kernel of the path never launched: "
                             f"{missing}")
    return out, launches


def bench_data(dev):
    """bench.py's draw, in its order: X, y (f32 on the card) and Z."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = rng.standard_normal(N).astype(np.float32)
    Z = rng.standard_normal((M, D)).astype(np.float32)
    return torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev), Z


def bench_model(dev, Z, dtype):
    params = {"log_ell": np.float32(LOG_ELL), "log_sf2": np.float32(LOG_SF2)}
    return from_jax_params(params, Z, np.float32(SIGMA2), device=dev,
                           dtype=dtype)


def slice_phase(dev, card: str, data) -> list[dict]:
    X32, y32, Z = data
    k32, z32, s32 = bench_model(dev, Z, torch.float32)
    k64, z64, s64 = bench_model(dev, Z, torch.float64)
    X64, y64 = X32.double(), y32.double()

    # -- the main path, through the entry points, counted
    def serve():
        with torch.no_grad():
            evidence = {
                impl: float(streaming.streaming_log_evidence(
                    k32, z32, s32, X32, y32, jitter=JITTER,
                    block_size=BLOCK, impl=impl))
                for impl in ("fused_acc", "fused")
            }
            _, _, coeffs = streaming.streaming_coeffs(
                k32, z32, s32, X32, y32, jitter=JITTER, block_size=BLOCK)
            means = streaming.predict_means_blocked(k32, z32, coeffs, X32,
                                                    block_size=65_536)
        return evidence, coeffs, means

    (evidence, coeffs, means), launches = counted("slice", serve, KERNELS)

    # -- checks against the pinned truth and the f64 twin
    with torch.no_grad():
        ev64 = float(streaming.streaming_log_evidence(
            k64, z64, s64, X64, y64, jitter=JITTER, block_size=BLOCK,
            impl="reference"))
        _, _, coeffs64 = streaming.streaming_coeffs(
            k64, z64, s64, X64, y64, jitter=JITTER, block_size=BLOCK,
            impl="reference")
    for impl, ev in evidence.items():
        rel = (ev - TRUTH) / abs(TRUTH)
        log(f"slice evidence f32 impl={impl}: {ev:.3f} (truth {TRUTH}; "
            f"{ev - TRUTH:+.3f} nats, rel {rel:+.2e})")
        if not abs(rel) <= 2e-5:
            raise AssertionError(f"impl={impl} evidence off by rel {rel:.2e}")
    log(f"slice evidence f64 twin: {ev64:.4f} ({ev64 - TRUTH:+.4f} nats)")
    if not abs(ev64 - TRUTH) <= 1.0:
        raise AssertionError(f"f64 twin evidence off by {ev64 - TRUTH:+.4f}")
    c_rel = float(torch.linalg.norm(coeffs.double() - coeffs64)
                  / torch.linalg.norm(coeffs64))
    log(f"slice coeffs rel err vs f64 twin: {c_rel:.2e}; means "
        f"{tuple(means.shape)} finite={bool(torch.isfinite(means).all())}")
    if not c_rel <= 1e-3:
        raise AssertionError(f"coefficients off by rel {c_rel:.2e}")
    if tuple(means.shape) != (N,) or not bool(torch.isfinite(means).all()):
        raise AssertionError("predicted means are not finite of shape (N,)")

    # -- each kernel against the twin at the path's shapes, and timings
    with torch.no_grad():
        args = stats_inputs(k32, z32, s32, X32, y32, JITTER)
        want = fused_stats._se_iso_stats_reference(
            *as_f64(args), block_size=BLOCK, acc_dtype=torch.float64)

        def twin32():
            return fused_stats._se_iso_stats_reference(
                *args, block_size=BLOCK, acc_dtype=torch.float32)

        plain_ms = median_ms(twin32)
        log(f"time twin f32 forward stats: {plain_ms:.3f} ms ({card})")
        rows = []
        b = stats_bound(N, D, M)
        flops = 2.0 * N * (M * D + M * (M + 1) + M)
        for name, replaces in KERNELS.items():
            fn = getattr(fused_stats, name)

            def run(fn=fn):
                return fn(*args, block_size=BLOCK, acc_dtype=torch.float32)

            got = fn(*args, block_size=BLOCK, acc_dtype=torch.float64)
            errs = rel_errors(got, want)
            check_errors(f"slice {name}", errs)
            max_abs = max(float((g - w).abs().max())
                          for g, w in zip(got[:2], want[:2]))
            sampler = clock_log()
            try:
                t0 = time.time()
                ms = median_ms(run)
                t1 = time.time()
            finally:
                samples = read_clock_log(sampler)
            prev = PREV_STATS_MS[name]
            log(f"time {name}: {ms:.3f} ms (previous kernel {prev:.2f} ms: "
                f"{prev / ms:.2f}x) = {flops / ms / 1e9:.2f} TFLOP/s = "
                f"{100 * b['bound_ms'] / ms:.1f} % of the {b['bound_ms']:.3f} "
                f"ms bound; twin {plain_ms:.3f} ms; max |err| of G and u "
                f"{max_abs:.3e}; {clock_window(samples, t0, t1)} ({card})")
            rows.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                **b, "library_ms": None,
            })

        for impl in ("fused_acc", "reference"):
            ms = median_ms(lambda impl=impl: streaming.streaming_log_evidence(
                k32, z32, s32, X32, y32, jitter=JITTER, block_size=BLOCK,
                impl=impl))
            log(f"time evidence f32 impl={impl}: {ms:.3f} ms ({card})")
        ms = median_ms(lambda: streaming.predict_means_blocked(
            k32, z32, coeffs, X32, block_size=65_536))
        log(f"time predict means 1M: {ms:.3f} ms = {N / ms / 1e3:.1f} M "
            f"pts/s ({card})")
    return rows


def step_phase(dev, card: str, data) -> dict:
    X32, y32, Z = data

    def value_and_grad(dtype, impl, X, y):
        kernel, z, s2 = bench_model(dev, Z, dtype)
        z.requires_grad_(True)
        s2.requires_grad_(True)
        ev = streaming.streaming_log_evidence(
            kernel, z, s2, X, y, jitter=JITTER, block_size=BLOCK, impl=impl)
        ev.backward()
        return ev.item(), (kernel.log_ell.grad, kernel.log_sf2.grad, z.grad,
                           s2.grad)

    # -- the main path, through the entry point, counted
    (ev, grads), launches = counted(
        "step", lambda: value_and_grad(torch.float32, "fused_acc", X32, y32),
        ("se_iso_stream_stats_fused_acc", BWD_KERNEL))
    rel = (ev - TRUTH) / abs(TRUTH)
    log(f"step evidence f32: {ev:.3f} ({ev - TRUTH:+.3f} nats, rel "
        f"{rel:+.2e})")
    if not abs(rel) <= 2e-5:
        raise AssertionError(f"step evidence off by rel {rel:.2e}")
    _, grads64 = value_and_grad(torch.float64, "reference", X32.double(),
                                y32.double())
    for name, g, w in zip(("log_ell", "log_sf2", "z", "sigma2"), grads,
                          grads64):
        err = float(torch.linalg.norm(g.double() - w) / torch.linalg.norm(w))
        log(f"step grad {name}: rel err {err:.2e} vs f64 twin (|grad| "
            f"{float(torch.linalg.norm(w)):.4e})")
        if not (err <= 1e-3 and bool(torch.isfinite(g).all())):
            raise AssertionError(f"step grad {name} off by rel {err:.3e}")

    # -- timings of the step, and the backward kernel alone at its shapes
    for impl in ("fused_acc", "reference"):
        ms = median_ms(lambda impl=impl: value_and_grad(torch.float32, impl,
                                                        X32, y32))
        log(f"time value+grad f32 impl={impl}: {ms:.3f} ms ({card})")
    k32, z32, s32 = bench_model(dev, Z, torch.float32)
    k64, z64, _ = bench_model(dev, Z, torch.float64)
    with torch.no_grad():
        args = stats_inputs(k32, z32, s32, X32, y32, JITTER)
        stats = fused_stats.se_iso_stream_stats_fused_acc(
            *args, block_size=BLOCK, acc_dtype=torch.float64)
    cot32 = [c.float() for c in epilogue_cotangents(k64, z64, stats)]
    kernel_fn = getattr(fused_stats, BWD_KERNEL)
    with torch.no_grad():
        got = kernel_fn(*args, None, *cot32, block_size=BLOCK,
                        acc_dtype=torch.float64, need_y=False)
        want = fused_stats._se_iso_bwd_reference(
            *as_f64(args), None, *as_f64(cot32), block_size=BLOCK,
            acc_dtype=torch.float64, need_y=False)
        check_bwd(f"step {BWD_KERNEL}", bwd_errors(got, want))
        max_abs = max(float((got[2] - want[2]).abs().max()),
                      float((got[3].triu() - want[3].triu()).abs().max()))
        sampler = clock_log()
        try:
            t0 = time.time()
            ms = median_ms(lambda: kernel_fn(
                *args, None, *cot32, block_size=BLOCK,
                acc_dtype=torch.float32, need_y=False))
            t1 = time.time()
        finally:
            samples = read_clock_log(sampler)
        plain_ms = median_ms(lambda: fused_stats._se_iso_bwd_reference(
            *args, None, *cot32, block_size=BLOCK, acc_dtype=torch.float32,
            need_y=False))
    b = bwd_bound(N, D, M)
    flops = 1e-3 * b["bound_ms"] * PEAK_FP32  # the bound is by operations
    props = torch.cuda.get_device_properties(dev)
    geo = fused_stats._bwd_geometry(N, M, D, props.multi_processor_count,
                                    props.L2_cache_size)
    # each tile reads and writes back the hi and lo of a partial of the U^-1
    # cotangent; a partial's first tile only writes it
    part_bytes = 2 * 4 * geo.nblk * 64
    rmw_gb = 1e-9 * part_bytes * (2 * geo.n_tiles - geo.n_parts)
    log(f"time {BWD_KERNEL}: {ms:.3f} ms (previous kernel {PREV_BWD_MS:.2f} "
        f"ms: {PREV_BWD_MS / ms:.2f}x) = {flops / ms / 1e9:.2f} TFLOP/s = "
        f"{100 * b['bound_ms'] / ms:.1f} % of the {b['bound_ms']:.3f} ms "
        f"bound; {rmw_gb:.2f} GB a step of partial read-modify-write beside "
        f"it ({geo.n_tiles} tiles, {geo.n_ctas} CTAs, {geo.share} a partial: "
        f"{1e-6 * part_bytes * geo.n_parts:.1f} MB of partials beside "
        f"{1e-6 * props.L2_cache_size:.1f} MB of L2); twin {plain_ms:.3f} "
        f"ms; max |err| of z_bar and u_inv_bar {max_abs:.3e}; "
        f"{clock_window(samples, t0, t1)} ({card})")
    return {
        "name": BWD_KERNEL, "route": "cuda", "source": BWD_SOURCE,
        "replaces": BWD_REPLACES, "launches": launches[BWD_KERNEL],
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b,
        "library_ms": None,
    }


def bench_targets(dev, X32):
    """bench.py's training targets: sin(X (0.3 k + 0.2)) + 0.3 noise."""
    w = torch.arange(D, dtype=torch.float32, device=dev) * 0.3 + 0.2
    noise = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    return torch.sin(X32 @ w) + 0.3 * torch.as_tensor(noise, device=dev)


def mean_nll(x, pack, X32, yf) -> float:
    with torch.no_grad():
        return -float(streaming.streaming_log_evidence(
            *pack.unpack(x), X32, yf, variational=True,
            block_size=BLOCK)) / N


def fit_phase(dev, card: str, data) -> None:
    X32, _, Z = data
    yf = bench_targets(dev, X32)
    kernel = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float32)
    pack = make_pack(kernel, torch.as_tensor(Z, device=dev), 1.0)
    f0 = mean_nll(pack.x0, pack, X32, yf)
    t0 = time.perf_counter()
    (_, _, s2, st), _ = counted(
        "fit", lambda: fit(X32, yf, pack, variational=True,
                           streaming_block_size=BLOCK, max_iter=10,
                           epsabs=1e-4),
        ("se_iso_stream_stats_fused_acc", BWD_KERNEL))
    secs = time.perf_counter() - t0
    f, gnorm = float(st.f), float(torch.linalg.norm(st.g))
    log(f"fit: n_iter {st.n_iter}, n_evals {st.n_evals}, failed "
        f"{st.failed}, mean NLL {f0:.6f} -> {f:.6f}, |g| {gnorm:.3e}, "
        f"sigma2 {float(s2):.4f}, {secs:.2f} s = "
        f"{1e3 * secs / st.n_evals:.1f} ms per evaluation ({card})")
    if not (np.isfinite(f) and bool(torch.isfinite(st.x).all())):
        raise AssertionError("fit: non-finite objective or iterate")
    if not (st.n_iter >= 1 and f < f0):
        raise AssertionError(f"fit: mean NLL did not decrease ({f0} -> {f})")


def chain_inputs(n, m, gen, dev):
    """The probe's operands: x ~ 0.1 N(0, 1), W ~ 0.05 N(0, 1), f32."""
    x = torch.randn(n, m, device=dev, generator=gen) * 0.1
    w = torch.randn(m, m, device=dev, generator=gen) * 0.05
    return x, w


def chain_error(x, w, reps, got=None):
    """(relative Frobenius error, max |error|) of the kernel against its
    f64 twin on the same inputs."""
    if got is None:
        got = gemm_chain(x, w, reps)
    want = _gemm_chain_reference(x.double(), w.double(), reps)
    diff = got.double() - want
    return (float(torch.linalg.norm(diff) / torch.linalg.norm(want)),
            float(diff.abs().max()))


def chain_ptxas() -> dict:
    """{G: (registers, spill store bytes, spill load bytes)} of each
    gemm_chain_kernel<G> in this run's build log."""
    return {int(g): v for (g,), v in
            ptxas_report(r"gemm_chain_kernelILi(\d+)E").items()}


def roofline_phase(dev, card: str) -> dict:
    gen = torch.Generator(device=dev).manual_seed(4)
    # -- the build: registers and spills; the launch geometry
    report = chain_ptxas()
    log("gemm_chain ptxas: " + ("; ".join(
        f"G={g}: {r} registers, spill {st}/{ld} bytes"
        for g, (r, st, ld) in report.items()) or "not built in this run"))
    if report and (sorted(report) != list(range(1, 7)) or any(
            st or ld for _, st, ld in report.values())):
        raise AssertionError(f"gemm_chain instantiations spill or are "
                             f"missing: {report}")
    lib = _build.load_library()
    for m in range(1, MAX_M + 1):
        if _geometry(1, m, 1).smem_bytes != lib.gemm_chain_smem_bytes(m):
            raise AssertionError(f"m={m}: _geometry's shared memory differs "
                                 f"from the library's")
    # -- (a) the kernel against its f64 twin
    checks = [(65_536, m, reps) for m, reps in ((384, 1), (384, 4),
                                                 (300, 3))]
    checks += [(100_003, m, 1 + i % 4)
               for i, m in enumerate((8, 37, 64, 65, 129, 200, 300, 384))]
    for n, m, reps in checks:
        rel, _ = chain_error(*chain_inputs(n, m, gen, dev), reps)
        log(f"roofline check n={n} m={m} G={_geometry(n, m, 1).groups} "
            f"reps={reps}: rel err {rel:.2e} vs f64 twin (bound 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"gemm_chain off by rel {rel:.3e}")

    # -- (b) the probe's leg-1 shapes and (c) bench.py's ceiling shape,
    #    each driven once through the wrapper, counted
    shapes = (("probe B=1024", 977 * 1024, 384, 1),
              ("probe B=2048", 488 * 2048, 384, 1),
              ("probe B=2048", 488 * 2048, 384, 4),
              ("bench ceiling", 61 * 16_384, 300, 3))
    inputs = {}
    for _, n, m, _ in shapes:
        if (n, m) not in inputs:
            inputs[n, m] = chain_inputs(n, m, gen, dev)

    def roofline():
        return [gemm_chain(*inputs[n, m], reps)
                for _, n, m, reps in shapes]

    outs, launches = counted("roofline", roofline, ("gemm_chain",))
    rel, max_abs = chain_error(*inputs[shapes[-1][1:3]], shapes[-1][3],
                               got=outs[-1])
    del outs
    log(f"roofline bench ceiling: rel err {rel:.2e}, max |err| "
        f"{max_abs:.3e} vs f64 twin")
    if not rel <= 1e-5:
        raise AssertionError(f"gemm_chain off by rel {rel:.3e}")

    def matmul_chain(x, w, reps):
        acc = x
        for _ in range(reps):
            acc = torch.matmul(acc, w)
        return acc

    # The kernel and the torch.matmul chain are timed in turns (kernel,
    # library, library, kernel) so that both see the same clock: the kernel
    # can draw the card to its power limit, and the clock then drops.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    sampler, timed = clock_log(), []
    try:
        for label, n, m, reps in shapes:
            x, w = inputs[n, m]
            t0 = time.time()
            kernel_ms, lib_ms = [], []
            torch.backends.cuda.matmul.allow_tf32 = False
            for fn, times in ((gemm_chain, kernel_ms),
                              (matmul_chain, lib_ms), (matmul_chain, lib_ms),
                              (gemm_chain, kernel_ms)):
                times += event_times(lambda fn=fn: fn(x, w, reps))
            plain_ms = statistics.median(event_times(
                lambda: _gemm_chain_reference(x, w, reps)))
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32_ms = statistics.median(event_times(
                lambda: matmul_chain(x, w, reps)))
            torch.backends.cuda.matmul.allow_tf32 = tf32
            timed.append((label, n, m, reps, statistics.median(kernel_ms),
                          statistics.median(lib_ms), plain_ms, tf32_ms, t0,
                          time.time()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        samples = read_clock_log(sampler)
    # the last shape, bench's, fills the JSON row
    for label, n, m, reps, ms, lib_ms, plain_ms, tf32_ms, t0, t1 in timed:
        b = chain_bound(n, m, reps)
        tflops = 2.0 * n * m * m * reps / ms / 1e9
        prev = PREV_CHAIN_MS[n, m, reps]
        clock = clock_window(samples, t0, t1)
        log(f"time gemm_chain {label} n={n} m={m} reps={reps}: {ms:.3f} ms "
            f"(previous kernel {prev:.2f} ms: {prev / ms:.2f}x) = "
            f"{tflops:.2f} TFLOP/s = {100 * tflops / 67:.1f} % of FP32 "
            f"peak; bound {b['bound_ms']:.3f} ms ({b['bound_by']}) = "
            f"{100 * b['bound_ms'] / ms:.1f} % of bound; torch.matmul chain "
            f"fp32 {lib_ms:.3f} ms in turns with it ({lib_ms / ms:.2f}x the "
            f"kernel's time; tf32 {tf32_ms:.3f} ms, information only); twin "
            f"{plain_ms:.3f} ms; {clock} (CUDA events; {card})")
    return {
        "name": "gemm_chain", "route": "cuda", "source": CHAIN_SOURCE,
        "replaces": CHAIN_REPLACES, "launches": launches["gemm_chain"],
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b,
        "library_ms": lib_ms,
    }


def restarts_phase(dev, card: str, data) -> None:
    X32, _, Z = data
    yf = bench_targets(dev, X32)
    z = torch.as_tensor(Z, device=dev)
    pack = make_pack(SeIso(LOG_ELL, LOG_SF2, device=dev,
                           dtype=torch.float32), z, 1.0)
    x0s = [make_pack(SeIso(le, LOG_SF2, device=dev, dtype=torch.float32),
                     z, 1.0).x0 for le in LADDER]
    t0 = time.perf_counter()
    (_, _, s2, st, rep), _ = counted(
        "restarts", lambda: fit_restarts(
            X32, yf, pack, x0s, probe_iters=12, variational=True,
            streaming_block_size=BLOCK, max_iter=60, epsabs=1e-4,
            rescore_f64=20_000),
        ("se_iso_stream_stats_fused_acc", BWD_KERNEL))
    secs = time.perf_counter() - t0
    pe, pi = rep.probe_evals, max(1, rep.probe_iters)
    ce, ci = rep.cont_evals, max(1, rep.cont_iters)
    f, gnorm = float(st.f), float(torch.linalg.norm(st.g))
    log(f"restarts: ladder {LADDER} probes {[round(v, 6) for v in rep]} "
        f"rescored_f64 {[round(v, 6) for v in rep.rescored_f64]} winner "
        f"{rep.winner}; iters {st.n_iter} evals {st.n_evals} [probe phase "
        f"{pe} evals/{rep.probe_iters} iters = {pe / pi:.1f}/iter; "
        f"continuation {ce}/{rep.cont_iters} = {ce / ci:.1f}/iter]; mean NLL "
        f"{f:.6f}, |g| {gnorm:.3e}, sigma2 {float(s2):.4f}; {secs:.2f} s in "
        f"all = {1e3 * secs / (pe + ce):.1f} ms per f32 evaluation, the f64 "
        f"rescoring included ({card})")
    if not all(np.isfinite(v) for v in (*rep, *rep.rescored_f64)):
        raise AssertionError("restarts: a probe or rescored value is not "
                             "finite")
    f_start = mean_nll(x0s[rep.winner], pack, X32, yf)
    log(f"restarts winner: mean NLL {f_start:.6f} at its start -> {f:.6f}")
    if not (np.isfinite(f) and f < f_start):
        raise AssertionError(f"restarts: the winner's mean NLL did not "
                             f"fall ({f_start} -> {f})")

    t0 = time.perf_counter()
    _, _, s2p, _, prep = polish(X32, yf, pack, st.x, variational=True,
                                subsample=20_000, max_iter=30, epsabs=1e-3)
    secs = time.perf_counter() - t0
    log(f"polish f64 on {X32.device} ({prep.n_rows} rows): mean NLL "
        f"{prep.f0:.6f} -> {prep.f:.6f}, |g| {prep.gnorm0:.3e} -> "
        f"{prep.gnorm:.3e} in {prep.n_iter} iters/{prep.n_evals} evals, "
        f"converged {prep.converged}, sigma2 {float(s2p):.4f}; {secs:.2f} s "
        f"({card})")
    if not prep.gnorm < prep.gnorm0:
        raise AssertionError(f"polish: |g| did not fall ({prep.gnorm0} -> "
                             f"{prep.gnorm})")


def rel_norm(got, want) -> float:
    """Relative 2-norm error, in f64."""
    return float(torch.linalg.norm(got.double() - want.double())
                 / torch.linalg.norm(want.double()))


def check(tag: str, ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"{tag}: {what}")


def quickstart_train(dev, card, X32, yf, z) -> object:
    """(a) The README's ``train`` at bench's shape, uninterrupted, then
    stopped by a Bailout after iteration 5 and resumed from its checkpoint.
    Returns the uninterrupted result."""
    def run(**kw):
        return train(SeIso, X32, yf,
                     kernel_params=SeIso(LOG_ELL, LOG_SF2, device=dev,
                                         dtype=torch.float32),
                     inducing=z, sigma2=1.0, variational=True,
                     block_size=BLOCK, max_iter=10, epsabs=1e-6, **kw)

    norms = []
    t0 = time.perf_counter()
    result, launches = counted(
        "quickstart train",
        lambda: run(report_gradient_norm=lambda iter, norm: norms.append(
            norm)),
        ("se_iso_stream_stats_fused_acc", BWD_KERNEL))
    secs = time.perf_counter() - t0
    # one backward launch an evaluation; the forward one more, for the
    # trained state reported at the end
    evals, iters = launches[BWD_KERNEL], len(norms) - 1
    with torch.no_grad():
        l0 = float(streaming.streaming_log_evidence(
            SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float32), z,
            torch.tensor(1.0, device=dev), X32, yf, variational=True,
            block_size=BLOCK))
    l = float(result.l)
    log(f"quickstart train: {iters} iterations, {evals} evaluations, "
        f"{secs:.2f} s = {1e3 * secs / evals:.1f} ms per evaluation "
        f"(reporting included); evidence {l0:.3f} -> {l:.3f}; |g| "
        f"{norms[0]:.4e} -> {norms[-1]:.4e} (epsabs 1e-6: "
        f"{'met' if norms[-1] < 1e-6 else 'not met'}); sigma2 "
        f"{float(result.sigma2):.5f} ({card})")
    check("quickstart train", iters >= 1, "no accepted iteration")
    check("quickstart train", all(np.isfinite(norms)), f"gradient norms "
          f"{norms}")
    check("quickstart train", np.isfinite(l) and l >= l0, f"evidence "
          f"{l0} -> {l}")

    # the host round trip of one evaluation: x to the card, (f, g) back
    pack = make_pack(SeIso(LOG_ELL, LOG_SF2, device=dev,
                           dtype=torch.float32), z, 1.0)
    fg, _ = make_objective(X32, yf, pack, variational=True,
                           block_size=BLOCK)
    x_host = pack.x0.cpu().numpy().astype(np.float64)
    on_card = median_ms(lambda: fg(pack.x0))

    def round_trip():
        f, g = fg(torch.as_tensor(x_host, dtype=torch.float32, device=dev))
        return float(f), g.cpu().numpy().astype(np.float64)

    via_host = median_ms(round_trip)
    log(f"time quickstart evaluation: {on_card:.3f} ms on the card's "
        f"tensors, {via_host:.3f} ms through the host's f64 numpy "
        f"({via_host - on_card:+.3f} ms the round trip; {x_host.size} "
        f"hypers) ({card})")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/train.npz"

        def bail(iter, norm):
            if iter >= 5:
                raise Bailout

        t0 = time.perf_counter()
        partial = run(checkpoint_path=ckpt, report_gradient_norm=bail)
        t1 = time.perf_counter()
        resumed = run(checkpoint_path=ckpt, resume=True)
        t2 = time.perf_counter()
    got = torch.cat([resumed.kernel_params.log_ell.reshape(1),
                     resumed.kernel_params.log_sf2.reshape(1),
                     resumed.inducing.reshape(-1),
                     resumed.sigma2.reshape(1)])
    want = torch.cat([result.kernel_params.log_ell.reshape(1),
                      result.kernel_params.log_sf2.reshape(1),
                      result.inducing.reshape(-1),
                      result.sigma2.reshape(1)])
    equal = bool(torch.equal(got, want))
    rel = rel_norm(got, want)
    log(f"quickstart resume: bailed at iteration 5 with evidence "
        f"{float(partial.l):.3f} ({t1 - t0:.2f} s), resumed to "
        f"{float(resumed.l):.3f} ({t2 - t1:.2f} s); final hypers "
        f"{'bit-equal to' if equal else f'rel {rel:.3e} from'} the "
        f"uninterrupted run's ({card})")
    check("quickstart resume", rel <= 1e-6, f"hypers off by rel {rel:.3e}")
    return result


def means_errors(kernel, mp, X32, **means) -> tuple[dict, float]:
    """Each f32 mean vector's error against the f64 twin of the same model
    (its hypers, z and coeffs in f64), relative to the 2-norm of |Knm|
    |coeffs|: the size of the terms each mean sums.  Summing m terms in
    f32 errs by up to m u of that (u = 2^-24); the means themselves are
    smaller by the condition kappa = || |Knm| |coeffs| || / ||Knm coeffs||,
    which a broad kernel with cancelling coefficients makes large, and
    then their plain relative error is up to kappa times larger.  Returns
    (errors, kappa)."""
    k64 = SeIso.of(kernel.log_ell.double(), kernel.log_sf2.double())
    z64, c64 = mp.z.double(), mp.coeffs.double()
    want = torch.empty(N, dtype=torch.float64, device=X32.device)
    scale = torch.empty_like(want)
    for i in range(0, N, 65_536):
        knm = k64.k_cross(X32[i:i + 65_536].double(), z64)
        want[i:i + 65_536] = knm @ c64
        scale[i:i + 65_536] = knm.abs() @ c64.abs()
    norm = float(torch.linalg.norm(scale))
    errs = {name: float(torch.linalg.norm(got.double() - want)) / norm
            for name, got in means.items()}
    return errs, norm / float(torch.linalg.norm(want))


def quickstart_serve(dev, card, X32, result) -> None:
    """(b) Serving from the trained result: stats, predictors, covariances
    and samplers.

    The moment check: 4,096 FIC draws at 2,048 points.  Each point's
    sample variance has relative standard error sqrt(2 / 4,095) = 2.2 %;
    the mean over the points has at most that (points whose draws are
    fully correlated) and less as the independent diagonal term takes
    over, so a 5 % bound is over 2.2 standard errors in the worst case."""
    kernel, sigma2 = result.kernel_params, result.sigma2
    gen = torch.Generator(device=dev).manual_seed(6)
    sub = X32[:2048]
    with torch.no_grad():
        st = calc_stats(result.trained)
        metrics = {f: float(getattr(st, f)) for f in (
            "target_variance", "sse", "mse", "rmse", "smse", "msll", "mad",
            "maxad")}
        log("quickstart stats: n " + str(st.n_samples) + ", " + ", ".join(
            f"{k} {v:.6g}" for k, v in metrics.items()))
        check("quickstart stats", all(np.isfinite(v) for v in
                                      metrics.values())
              and metrics["smse"] < 1.0, f"{metrics}")

        mp = mean_predictor(result.trained)
        cvp = co_variance_predictor(result.model)
        means = predict_means(kernel, mp, X32)
        means_b = streaming.predict_means_blocked(kernel, mp.z, mp.coeffs,
                                                  X32, block_size=65_536)
        m_rel = rel_norm(means, means_b)
        m_errs, kappa = means_errors(kernel, mp, X32, predict_means=means,
                                     predict_means_blocked=means_b)
        var = predict_variances(kernel, cvp, X32, sigma2)
        var_b = streaming.predict_variances_blocked(
            kernel, cvp.z, cvp.chol_km, cvp.r_mat, X32, sigma2,
            block_size=65_536)
        v_rel = rel_norm(var, var_b)
        log(f"quickstart predict: means rel {m_rel:.2e} vs blocked; vs the "
            f"f64 twin, relative to |Knm| |coeffs| (bound 1e-5): "
            + ", ".join(f"{k} {v:.2e}" for k, v in m_errs.items())
            + f"; condition |Knm| |coeffs| / |means| {kappa:.3e}; variances "
            f"rel {v_rel:.2e} vs blocked (bound 1e-4), min variance "
            f"{float(var.min()):.4e}")
        check("quickstart predict", max(m_errs.values()) <= 1e-5,
              f"means {m_errs}")
        check("quickstart predict", v_rel <= 1e-4 and bool(
            (var > 0).all()), f"variances rel {v_rel}, min {var.min()}")

        cov_fic = covariances_fic(kernel, cvp, sub, sigma2)
        cov_fitc = covariances_fitc(kernel, cvp, sub, sigma2,
                                    predictive=False)
        errs = {"fic": rel_norm(torch.diagonal(cov_fic), var[:2048]),
                "fitc": rel_norm(torch.diagonal(cov_fitc) + sigma2,
                                 var[:2048])}
        log(f"quickstart covariances at 2,048 points: diagonal rel "
            f"{errs['fic']:.2e} (fic), {errs['fitc']:.2e} (fitc) vs the "
            f"variances (bound 1e-4)")
        check("quickstart covariances", max(errs.values()) <= 1e-4, errs)

        cs = cov_sampler(means[:2048], cov_fitc, sigma2)
        draws = cov_sample(gen, cs, 512)
        check("quickstart cov_sample", tuple(draws.shape) == (2048, 512)
              and bool(torch.isfinite(draws).all()), "draws")
        big = sample_fic_blocked(gen, kernel, cvp, X32, sigma2, 4)
        check("quickstart sample_fic_blocked", tuple(big.shape) == (N, 4)
              and bool(torch.isfinite(big).all()), "1M draws")
        many = sample_fic_blocked(gen, kernel, cvp, sub, sigma2, 4096)
        emp, pred = float(many.var(dim=1).mean()), float(var[:2048].mean())
        log(f"quickstart samples: cov_sample 2,048 x 512 finite; FIC 1M x 4 "
            f"finite; FIC 2,048 x 4,096: mean variance {emp:.5f} vs "
            f"predicted {pred:.5f} ({100 * (emp / pred - 1):+.2f} %, bound "
            f"5 %)")
        check("quickstart samples", abs(emp / pred - 1.0) <= 0.05,
              f"{emp} vs {pred}")

        times = {
            "calc_stats": median_ms(lambda: calc_stats(result.trained)),
            "predict_means 1M": median_ms(lambda: predict_means(kernel, mp,
                                                                X32)),
            "predict_variances 1M": median_ms(lambda: predict_variances(
                kernel, cvp, X32, sigma2)),
            "covariances_fitc 2,048": median_ms(lambda: covariances_fitc(
                kernel, cvp, sub, sigma2)),
            "cov_sampler + cov_sample 2,048 x 512": median_ms(
                lambda: cov_sample(gen, cov_sampler(means[:2048], cov_fitc,
                                                    sigma2), 512)),
            "sample_fic_blocked 1M x 4": median_ms(lambda: sample_fic_blocked(
                gen, kernel, cvp, X32, sigma2, 4)),
        }
    log("time quickstart serving: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in times.items()) + f" ({card})")


def quickstart_dense(dev, card, X32, yf, z) -> None:
    """(c) The dense legs on the first 20,000 rows, as the rescoring
    takes, and the choosers over all rows."""
    X20, y20 = X32[:20_000], yf[:20_000]

    def start():
        return dict(kernel_params=SeIso(LOG_ELL, LOG_SF2, device=dev,
                                        dtype=torch.float32),
                    inducing=z, sigma2=1.0)

    pack = make_pack(start()["kernel_params"], z, 1.0)

    def loo(x):
        with torch.no_grad():
            return float(loo_objective_fitc(*pack.unpack(x), X20, y20))

    t0 = time.perf_counter()
    *_, st = fit(X20, y20, pack, objective="loo", max_iter=10, epsabs=1e-4)
    secs = time.perf_counter() - t0
    loo0, loo1 = loo(pack.x0), loo(st.x)
    log(f"quickstart fit loo (20,000 rows): {st.n_iter} iterations, "
        f"{st.n_evals} evaluations, {secs:.2f} s; LOO {loo0:.3f} -> "
        f"{loo1:.3f} ({card})")
    check("quickstart fit loo", np.isfinite(float(st.f)) and bool(
        torch.isfinite(st.x).all()) and loo1 > loo0, f"{loo0} -> {loo1}")

    with torch.no_grad():
        l0 = float(log_evidence(*pack.unpack(pack.x0), X20, y20,
                                variational=True))
    for name, trainer in (("train_sgd", train_sgd), ("train_smd", train_smd)):
        secs = []
        for _ in range(2):  # the first call pays torch.func's set-up
            t0 = time.perf_counter()
            res = trainer(SeIso, X20, y20, variational=True, max_iter=5,
                          eta0=1e-5, **start())
            secs.append(time.perf_counter() - t0)
        l = float(res.l)
        log(f"quickstart {name} (20,000 rows, 5 iterations, eta0 1e-5): "
            f"best evidence {l:.3f} from {l0:.3f}, sigma2 "
            f"{float(res.sigma2):.5f}, {secs[0]:.2f} s, again {secs[1]:.2f} "
            f"s ({card})")
        check(f"quickstart {name}", np.isfinite(l) and l >= l0, f"{l0} -> "
              f"{l}")

    kernel = SeIso(device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(7)
    ms = median_ms(lambda: choose_n_random_inputs(gen, kernel, X32, M))
    zr = choose_n_random_inputs(gen, kernel, X32, M)
    found = torch.cat([(X32[None] == zr[i:i + 25, None]).all(-1).any(-1)
                       for i in range(0, M, 25)])
    distinct = torch.unique(zr, dim=0).shape[0]
    log(f"quickstart choose_n_random_inputs: {distinct} distinct rows, "
        f"{int(found.sum())} of {M} found in X, {ms:.3f} ms ({card})")
    check("quickstart choose_n_random_inputs", distinct == M and bool(
        found.all()), f"{distinct} distinct, {int(found.sum())} found")
    t0 = time.perf_counter()
    zk = choose_kmeans_inputs(gen, kernel, X32, M, iters=10,
                              subsample=100_000)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"quickstart choose_kmeans_inputs (100,000 rows, 10 iterations): "
        f"{tuple(zk.shape)} finite={bool(torch.isfinite(zk).all())}, "
        f"{1e3 * secs:.1f} ms ({card})")
    check("quickstart choose_kmeans_inputs", tuple(zk.shape) == (M, D)
          and bool(torch.isfinite(zk).all()), "centroids")


def quickstart_phase(dev, card: str, data) -> None:
    X32, _, Z = data
    yf = bench_targets(dev, X32)
    z = torch.as_tensor(Z, device=dev)
    result = quickstart_train(dev, card, X32, yf, z)
    quickstart_serve(dev, card, X32, result)
    quickstart_dense(dev, card, X32, yf, z)


# -- flagship: bench.py's se_fat leg (bench.py:539-563)
FLAGSHIP_BLOCK = 16_384  # bench.py's; se_fat runs the plain loop, no grid
FLAGSHIP_GRADS = ("log_sf2", "tproj", "log_hetero_skedasticity",
                  "log_multiscales_m05", "z", "sigma2")


def bench_tproj() -> np.ndarray:
    """bench.py's se_fat projection: the fourth draw of its
    ``default_rng(0)``, after X, y and Z, over D."""
    rng = np.random.default_rng(0)
    rng.standard_normal((N, D))
    rng.standard_normal(N)
    rng.standard_normal((M, D))
    return rng.standard_normal((D, D)) / D


def flagship_value_and_grad(dev, dtype, X, y, tproj):
    """The se_fat variational evidence and its gradient groups (in
    FLAGSHIP_GRADS order) at bench.py's flagship parameters."""
    kernel = SeFat(D, 0.1, tproj=tproj,
                   log_hetero_skedasticity=np.full(M, -5.0),
                   log_multiscales_m05=np.zeros((M, D)), device=dev,
                   dtype=dtype)
    with torch.no_grad():
        z = kernel.inducing_from_inputs(X[:M])
    z.requires_grad_(True)
    s2 = torch.tensor(SIGMA2, dtype=dtype, device=dev, requires_grad=True)
    ev = streaming.streaming_log_evidence(kernel, z, s2, X, y,
                                          variational=True,
                                          block_size=FLAGSHIP_BLOCK)
    ev.backward()
    grads = [getattr(kernel, name).grad for name in FLAGSHIP_GRADS[:4]]
    return ev.item(), (*grads, z.grad, s2.grad)


def flagship_phase(dev, card: str, data) -> None:
    """bench.py's flagship: se_fat variational FIC at 1M x 8, m = 300,
    value and gradient in f32 through the plain loop, held against its f64
    twin; no se_iso kernel may launch."""
    X32, y32, _ = data
    tproj = bench_tproj()
    (ev, grads), launches = counted(
        "flagship", lambda: flagship_value_and_grad(dev, torch.float32, X32,
                                                    y32, tproj), ())
    check("flagship launches", not any(launches.values()),
          f"se_fat launched a se_iso kernel: {launches}")
    ev64, grads64 = flagship_value_and_grad(dev, torch.float64,
                                            X32.double(), y32.double(),
                                            tproj)
    rel = (ev - ev64) / abs(ev64)
    log(f"flagship evidence f32: {ev:.3f} vs f64 twin {ev64:.3f} "
        f"({ev - ev64:+.3f} nats, rel {rel:+.2e})")
    check("flagship evidence", abs(rel) <= 2e-5, f"rel {rel:.3e}")
    for name, g, w in zip(FLAGSHIP_GRADS, grads, grads64):
        err = rel_norm(g, w)
        log(f"flagship grad {name}: rel err {err:.2e} vs f64 twin (|grad| "
            f"{float(torch.linalg.norm(w)):.4e})")
        check(f"flagship grad {name}", err <= 1e-3
              and bool(torch.isfinite(g).all()), f"rel {err:.3e}")
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    sampler = clock_log()
    try:
        t0 = time.time()
        ms = median_ms(lambda: flagship_value_and_grad(
            dev, torch.float32, X32, y32, tproj))
        t1 = time.time()
    finally:
        samples = read_clock_log(sampler)
    peak = torch.cuda.max_memory_allocated(dev) - base
    log(f"time flagship se_fat value+grad f32: {ms:.3f} ms (median of 5, "
        f"block {FLAGSHIP_BLOCK}); peak memory {peak / 2**20:.1f} MiB above "
        f"the data; {clock_window(samples, t0, t1)} ({card})")


# -- route: the default streaming route (impl=None) takes kernel #1, and #3
# when a gradient will be taken, wherever they fit the card
# (m, block, Z, gradient): bench's Z at its block and at a block that is no
# multiple of 64; the first 400 rows of X (the forward's and the backward's
# wide routes, 64- and 32-row tiles) with and without a gradient; and the
# first 1,000 rows, train's largest default m (48- and 24-row tiles).  At
# m = 1,000 f32 itself misses the section 2 bound on the z gradient (the
# f32 twin's z-bar lies 2.3e-3 from the f64 twin's on 20,000 rows), so that
# case is held against the f64 twin, no worse than the f32 loop.
ROUTE_CASES = ((M, BLOCK, "bench", True), (M, 1_000, "bench", True),
               (400, BLOCK, "rows", True), (400, BLOCK, "rows", False),
               (1_000, BLOCK, "rows", True))
ROUTE_F64_M = 1_000
ROUTE_LAST_M = 3_000  # the route table runs m = 1..this, and FWD_EDGES
FWD_KERNEL = "se_iso_stream_stats_fused_acc"


def route_value_and_grad(dev, X, y, z0, block, impl, grad=True):
    """SE-iso evidence (bench's hypers) and, when ``grad``, its gradient
    groups (log_ell, log_sf2, z, sigma2) through
    ``streaming_log_evidence``; without, the evidence under no_grad."""
    kernel = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=X.dtype)
    z = z0.to(X.dtype).clone().requires_grad_(grad)
    s2 = torch.tensor(SIGMA2, dtype=X.dtype, device=dev, requires_grad=grad)
    with torch.set_grad_enabled(grad):
        ev = streaming.streaming_log_evidence(
            kernel, z, s2, X, y, jitter=JITTER, block_size=block, impl=impl)
    if not grad:
        return ev.item(), ()
    ev.backward()
    return ev.item(), (kernel.log_ell.grad, kernel.log_sf2.grad, z.grad,
                       s2.grad)


def check_twin(tag, ev, grads, ev_want, grads_want, names) -> str:
    """The section 2 bounds against a twin: the evidence within 2e-5
    relative, each gradient group within 1e-3 (2-norm) and finite; returns
    the errors as text."""
    rel = (ev - ev_want) / abs(ev_want)
    check(f"{tag} evidence", abs(rel) <= 2e-5, f"rel {rel:.3e}")
    errs = []
    for name, g, w in zip(names, grads, grads_want):
        err = rel_norm(g, w)
        check(f"{tag} grad {name}", err <= 1e-3
              and bool(torch.isfinite(g).all()), f"rel {err:.3e}")
        errs.append(f"{name} {err:.2e}")
    return f"evidence rel {rel:+.2e}; grads {', '.join(errs)}"


def check_f64_twin(tag, dev, kernels, loop, X, y, z0, block, names) -> str:
    """The kernel route and the f32 loop, each against the f64 twin: the
    kernels' evidence within 2e-5 relative, each gradient group within
    1e-3 or, where the f32 loop misses that too, within twice the loop's
    error; returns the errors as text."""
    ev64, grads64 = route_value_and_grad(dev, X.double(), y.double(),
                                         z0.double(), block, "reference")
    (ev, grads), (ev_loop, grads_loop) = kernels, loop
    rel, rel_loop = ((e - ev64) / abs(ev64) for e in (ev, ev_loop))
    check(f"{tag} evidence vs f64", abs(rel) <= 2e-5, f"rel {rel:.3e}")
    errs = [f"evidence rel {rel:+.2e} (loop {rel_loop:+.2e})"]
    for name, g, g_loop, w in zip(names, grads, grads_loop, grads64):
        err, err_loop = rel_norm(g, w), rel_norm(g_loop, w)
        check(f"{tag} grad {name} vs f64", err <= max(1e-3, 2 * err_loop)
              and bool(torch.isfinite(g).all()),
              f"rel {err:.3e}, the f32 loop's {err_loop:.3e}")
        errs.append(f"{name} {err:.2e} (loop {err_loop:.2e})")
    return f"vs the f64 twin {ev64:.3f}: " + ", ".join(errs)


def route_phase(dev, card: str, data) -> None:
    """The default route: ``default_route`` against the library's shared
    memory on this card for every m in 1..ROUTE_LAST_M and FWD_EDGES at
    d = 8 and 20, with and without a gradient; then evidence (+ grad) with
    impl=None at bench's draw for ROUTE_CASES, counted, against the
    explicit plain loop (impl="reference") in f32, each timed against it."""
    X32, y32, Z = data
    lib = _build.load_library()
    props = torch.cuda.get_device_properties(dev)
    optin = props.shared_memory_per_block_optin
    last = {}
    for d in (D, 20):
        for m in (*range(1, ROUTE_LAST_M + 1), *FWD_EDGES):
            fwd = lib.se_iso_stats_smem_bytes(m, d) <= optin
            bwd = lib.se_iso_bwd_smem_bytes(m, d) <= optin
            for grad, fits in ((True, fwd and bwd), (False, fwd)):
                got = fused_stats.default_route(m, d, torch.float32, props,
                                                grad=grad)
                check(f"route m={m} d={d} grad={grad}",
                      got == ("fused_acc" if fits else "reference"),
                      f"default_route says {got}; the library's shared "
                      f"memory {'fits' if fits else 'does not fit'} {optin} "
                      f"bytes")
                if fits:
                    last[d, grad] = max(last.get((d, grad), 0), m)
    log(f"route: default_route agrees with the library's shared memory "
        f"against the card's {optin} bytes for m = 1..{ROUTE_LAST_M} and "
        f"{FWD_EDGES} at d = {D} and 20: with a gradient the kernels up to "
        f"m = {last[D, True]} at d = {D} and {last[20, True]} at d = 20; "
        f"without, #1 up to m = {last[D, False]} at d = {D} (the last of "
        f"those m it fits at d = 20: {last[20, False]})")
    zs = {"bench": torch.as_tensor(Z, device=dev), "rows": X32}
    names = ("log_ell", "log_sf2", "z", "sigma2")
    for m, block, zname, grad in ROUTE_CASES:
        z0 = zs[zname][:m]
        tag = f"route m={m} block={block} grad={grad}"
        t0 = time.perf_counter()
        (ev, grads), launches = counted(tag, lambda: route_value_and_grad(
            dev, X32, y32, z0, block, None, grad),
            (FWD_KERNEL, BWD_KERNEL) if grad else (FWD_KERNEL,))
        secs = time.perf_counter() - t0
        check(f"{tag} launches", launches[FWD_KERNEL] == 1 and launches[
            BWD_KERNEL] == int(grad), f"expected #1 once and #3 "
            f"{int(grad)} times: {launches}")
        ev_ref, grads_ref = route_value_and_grad(dev, X32, y32, z0, block,
                                                 "reference", grad)
        if m == ROUTE_F64_M:
            errs = check_f64_twin(tag, dev, (ev, grads), (ev_ref, grads_ref),
                                  X32, y32, z0, block, names)
        else:
            errs = check_twin(tag, ev, grads, ev_ref, grads_ref, names)
        ms, ms_ref = (median_ms(lambda: route_value_and_grad(
            dev, X32, y32, z0, block, impl, grad)) for impl in (None,
                                                                "reference"))
        log(f"{tag}: kernels #1{' and #3' if grad else ''}, evidence "
            f"{ev:.3f} vs impl='reference' {ev_ref:.3f}: {errs}; first call "
            f"{secs:.2f} s, {'value+grad' if grad else 'evidence'} "
            f"{ms:.3f} ms vs the plain loop's {ms_ref:.3f} ms (median of 5) "
            f"({card})")
    route_kernel_times(dev, card, X32, y32, X32[:1_000])


def route_kernel_times(dev, card, X, y, z0) -> None:
    """Kernels #1 and #3 alone at bench's rows and m = len(z0) (the wide
    routes) against their f32 twins and their bounds: host clock, median
    of 5."""
    m = z0.shape[0]
    kernel = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float32)
    k64 = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float64)
    s2 = torch.tensor(SIGMA2, dtype=torch.float32, device=dev)
    f32 = torch.float32
    with torch.no_grad():
        args = stats_inputs(kernel, z0.contiguous(), s2, X, y, JITTER)
        stats = fused_stats.se_iso_stream_stats_fused_acc(
            *args, block_size=BLOCK, acc_dtype=torch.float64)
    cot = [c.float() for c in epilogue_cotangents(k64, z0.double(), stats)]
    fwd, bwd = (getattr(fused_stats, n) for n in (FWD_KERNEL, BWD_KERNEL))
    with torch.no_grad():
        times = {
            "#1": median_ms(lambda: fwd(*args, block_size=BLOCK)),
            "#1 twin": median_ms(lambda: fused_stats._se_iso_stats_reference(
                *args, block_size=BLOCK, acc_dtype=f32)),
            "#3": median_ms(lambda: bwd(*args, None, *cot, block_size=BLOCK)),
            "#3 twin": median_ms(lambda: fused_stats._se_iso_bwd_reference(
                *args, None, *cot, block_size=BLOCK, acc_dtype=f32)),
        }
    for name, b, geo in (
            ("#1", stats_bound(N, D, m), fused_stats._geometry(N, m, D, 132)),
            ("#3", bwd_bound(N, D, m), fused_stats._bwd_geometry(N, m, D, 132))):
        ms = times[name]
        log(f"time route m={m} kernel {name} (wide, {geo.rows}-row tiles): "
            f"{ms:.3f} ms = {100 * b['bound_ms'] / ms:.1f} % of the "
            f"{b['bound_ms']:.3f} ms bound; f32 twin {times[name + ' twin']:.3f}"
            f" ms ({card})")


# -- families: the base kernel families on the streaming path at bench's
# full shape, through the plain loop (no kernel)
FAMILY_BLOCK = FLAGSHIP_BLOCK
STATIONARY = ("se_ard", "matern32", "matern52", "rq", "periodic")
# K(Z, Z) at m = 300 has rank 2 (cosine), d + 1, d and 1: the f32 Cholesky
# holds only jitter there, so these run in f64 and are held against the
# same function on the CPU over the first LOW_RANK_ROWS rows
LOW_RANK = ("cosine", "lin_one", "lin_ard", "const")
LOW_RANK_ROWS = 100_000
EPS64 = float(np.finfo(np.float64).eps)


def family_kernel(name, X32):
    """The family's default_params on bench's draw (cosine's frequencies
    from a generator on the card seeded 0), as field tensors."""
    gen = torch.Generator(X32.device).manual_seed(0)
    k = FAMILIES[name].default_params(X32, M, gen)
    return {f: getattr(k, f).detach() for f in type(k).param_names}


def family_value_and_grad(name, fields, X, y):
    """Variational evidence at bench's shape (Z = the family's inducing
    representation of X's first 300 rows, sigma2 0.1, jitter 1e-6, block
    16,384) and its gradient groups by name, in X's dtype on X's device:
    the hyper fields, z and sigma2 (z of const has no columns: zero)."""
    cls = FAMILIES[name]
    kernel = cls(**fields, device=X.device, dtype=X.dtype)
    with torch.no_grad():
        z = kernel.inducing_from_inputs(X[:M])
    z.requires_grad_(True)
    s2 = torch.tensor(SIGMA2, dtype=X.dtype, device=X.device,
                      requires_grad=True)
    ev = streaming.streaming_log_evidence(kernel, z, s2, X, y,
                                          variational=True, jitter=JITTER,
                                          block_size=FAMILY_BLOCK)
    names, hypers = hyper_leaves(kernel)
    wrt = (*hypers, z, s2)
    grads = torch.autograd.grad(ev, wrt, allow_unused=True)
    return ev.item(), {n: torch.zeros_like(t) if g is None else g
                       for n, t, g in zip((*names, "z", "sigma2"), wrt,
                                          grads)}


def time_family(tag, fn, dev, card, block=FAMILY_BLOCK) -> None:
    """Median of 5 value+grad runs, the peak memory above what was
    allocated before, the SM clock and the power draw."""
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    sampler = clock_log()
    try:
        t0 = time.time()
        ms = median_ms(fn)
        t1 = time.time()
    finally:
        samples = read_clock_log(sampler)
    peak = torch.cuda.max_memory_allocated(dev) - base
    log(f"time {tag}: {ms:.3f} ms (median of 5, block {block}); peak "
        f"memory {peak / 2**20:.1f} MiB above the data; "
        f"{clock_window(samples, t0, t1)} ({card})")


def low_rank_kappa(name, fields, X) -> float:
    """The condition number of K(Z, Z) + jitter I of the family's default
    at bench's Z (f64, on the CPU): a rank-deficient Gram leaves its small
    eigenvalues to the jitter, and a solve with it amplifies rounding up
    to that factor."""
    kernel = FAMILIES[name](**fields, device="cpu", dtype=torch.float64)
    with torch.no_grad():
        z = kernel.inducing_from_inputs(X[:M].cpu().double())
        km = kernel.k_cross(z, z)
        km = km + JITTER * torch.eye(M, dtype=km.dtype)
        return float(torch.linalg.cond(km))


def families_phase(dev, card: str, data) -> None:
    """Each stationary family in f32 against its f64 twin on the card (the
    section 2 bounds); each low-rank family in f64 on the card against the
    CPU over the first 100,000 rows: the evidence within 1e-8 relative, the
    hyper and sigma2 gradients within max(1e-8, eps kappa), kappa the
    condition number of K(Z, Z) + jitter I (the amplification of rounding
    by the solves: 3e8 for const's rank-1 Gram); the z gradient, which a
    rank-deficient K(Z, Z) leaves to the jitter, is printed.  No kernel may
    launch."""
    X32, y32, _ = data
    X64, y64 = X32.double(), y32.double()
    for name in STATIONARY:
        fields = family_kernel(name, X32)
        (ev, grads), launches = counted(
            f"families {name}", lambda: family_value_and_grad(
                name, fields, X32, y32), ())
        check(f"families {name} launches", not any(launches.values()),
              f"{name} launched a se_iso kernel: {launches}")
        ev64, grads64 = family_value_and_grad(name, fields, X64, y64)
        errs = check_twin(f"families {name}", ev, list(grads.values()),
                          ev64, list(grads64.values()), list(grads))
        log(f"families {name} f32: evidence {ev:.3f} vs f64 twin "
            f"{ev64:.3f}: {errs}")
        time_family(f"families {name} value+grad f32", lambda: (
            family_value_and_grad(name, fields, X32, y32)), dev, card)
    Xc, yc = X64[:LOW_RANK_ROWS], y64[:LOW_RANK_ROWS]
    for name in LOW_RANK:
        fields = family_kernel(name, X32)
        if name == "cosine":
            ev, _ = family_value_and_grad(name, fields, X32, y32)
            log(f"families cosine f32 (for information, not held): evidence "
                f"{ev:.3f}; the f32 Cholesky of its rank-2 K(Z, Z)")
        (ev, grads), launches = counted(
            f"families {name}", lambda: family_value_and_grad(
                name, fields, X64, y64), ())
        check(f"families {name} launches", not any(launches.values()),
              f"{name} launched a se_iso kernel: {launches}")
        check(f"families {name} f64", np.isfinite(ev) and all(
            bool(torch.isfinite(g).all()) for g in grads.values()),
              "not finite")
        ev_gpu, g_gpu = family_value_and_grad(name, fields, Xc, yc)
        ev_cpu, g_cpu = family_value_and_grad(name, fields, Xc.cpu(),
                                              yc.cpu())
        rel = (ev_gpu - ev_cpu) / abs(ev_cpu)
        check(f"families {name} card vs CPU evidence", abs(rel) <= 1e-8,
              f"rel {rel:.3e}")
        kappa = low_rank_kappa(name, fields, X64)
        tol = max(1e-8, EPS64 * kappa)
        errs = []
        for field, g in g_gpu.items():
            err = rel_norm(g.cpu(), g_cpu[field]) if torch.any(
                g_cpu[field]) else float(torch.linalg.norm(g))
            if field != "z":
                check(f"families {name} card vs CPU grad {field}",
                      err <= tol, f"rel {err:.3e} > {tol:.2e}")
            errs.append(f"{field} {err:.2e}")
        log(f"families {name} f64 on the card vs the CPU over "
            f"{LOW_RANK_ROWS} rows: evidence rel {rel:+.2e}; grads "
            f"{', '.join(errs)} (bound {tol:.2e}: kappa of K(Z, Z) + jitter "
            f"{kappa:.2e}; z not held: with K(Z, Z) of rank <= d + 1 its "
            f"gradient is the jitter's); full-shape evidence {ev:.3f}")
        time_family(f"families {name} value+grad f64", lambda: (
            family_value_and_grad(name, fields, X64, y64)), dev, card)


# -- composites: the combinators, the ICM task kernel and the spectral
# mixture on the plain loop (no combinator has a kernel or a hand pullback)
ICM_TASKS, ICM_RANK, ICM_BLOCK = 4, 2, 32_768  # bench.py's ICM leg
SM_INIT_ROWS = 100_000


def bench_task_ids():
    """bench.py's task ids for its ICM leg: the draws of its
    ``default_rng(0)`` after X, y, Z and the se_fat projection, for the rows
    and then for Z."""
    rng = np.random.default_rng(0)
    rng.standard_normal((N, D))
    rng.standard_normal(N)
    rng.standard_normal((M, D))
    rng.standard_normal((D, D))
    return (rng.integers(0, ICM_TASKS, N).astype(np.float32),
            rng.integers(0, ICM_TASKS, M).astype(np.float32))


def composite_models(dev, data):
    """(tag, kernel class, f32 hyper fields, X, Z, block, variational) of
    each composite model at bench's shape: the ICM leg of bench.py (its
    task ids, block 32,768, the FITC evidence), the trend
    sum(se_iso,lin_ard), the spectral mixture sm2 initialized from the
    first 100,000 rows, and sm2 from its default_params (the last three
    variational, block 16,384).  The draws of default_params come from a
    generator on the card seeded 0."""
    X32, y32, Z = data
    tid_x, tid_z = (torch.as_tensor(t, device=dev)[:, None]
                    for t in bench_task_ids())
    X_icm = torch.cat([X32, tid_x], dim=1)
    Z_icm = torch.cat([torch.as_tensor(Z, device=dev), tid_z], dim=1)
    icm = icm_family(SeIso, D, ICM_TASKS, ICM_RANK)
    trend = resolve_family("sum(se_iso,lin_ard)")
    sm2 = sm_init_from_data(2, X32[:SM_INIT_ROWS], y32[:SM_INIT_ROWS])
    models = []
    for tag, kernel, X, z, block, variational in (
            ("icm", icm.default_params(
                X_icm, M, torch.Generator(dev).manual_seed(0)), X_icm,
             Z_icm, ICM_BLOCK, False),
            ("trend", trend.default_params(
                X32, M, torch.Generator(dev).manual_seed(0)), X32, X32[:M],
             FAMILY_BLOCK, True),
            ("sm2", sm2, X32, X32[:M], FAMILY_BLOCK, True),
            ("sm2-default", type(sm2).default_params(
                X32, M, torch.Generator(dev).manual_seed(0)), X32, X32[:M],
             FAMILY_BLOCK, True)):
        fields = {**static_fields(kernel), **{
            n: t.detach() for n, t in hyper_fields(kernel).items()}}
        models.append((tag, type(kernel), fields, X, z, block, variational))
    return models


def composite_value_and_grad(cls, fields, X, y, z0, block, variational,
                             grad_impl="custom"):
    """The streaming evidence of the composite ``cls`` with ``fields`` in
    X's dtype on X's device (sigma2 0.1, jitter 1e-6), and its gradient
    groups by name: the dotted hyper leaves, z and sigma2."""
    kernel = cls(**fields, device=X.device, dtype=X.dtype)
    z = z0.to(X.device, X.dtype).clone().requires_grad_(True)
    s2 = torch.tensor(SIGMA2, dtype=X.dtype, device=X.device,
                      requires_grad=True)
    ev = streaming.streaming_log_evidence(kernel, z, s2, X, y,
                                          variational=variational,
                                          jitter=JITTER, block_size=block,
                                          grad_impl=grad_impl)
    names, hypers = hyper_leaves(kernel)
    grads = torch.autograd.grad(ev, (*hypers, z, s2))
    return ev.item(), dict(zip((*names, "z", "sigma2"), grads))


def group_errors(grads, want) -> dict:
    """Each gradient group's error against ``want``: relative (2-norm), or,
    where ``want``'s group vanishes (below 1e-10 of the whole gradient's
    norm: the DC component's cosine mu at 0, by symmetry; a component too
    narrow to reach any pair but its coincident ones), relative to the
    whole gradient's norm."""
    scale = float(torch.linalg.norm(torch.cat(
        [w.double().reshape(-1) for w in want.values()])))
    errs = {}
    for name, g in grads.items():
        w = want[name].to(g.device)
        norm = float(torch.linalg.norm(w.double()))
        errs[name] = (rel_norm(g, w) if norm > 1e-10 * scale
                      else float(torch.linalg.norm(g.double() - w.double()))
                      / scale)
    return errs


# What an f32 run cannot resolve, printed against the f64 twin and held
# only in f64 (card against CPU).  trend: the lin_ard lengthscales, whose
# gradient (small beside se_iso's) is the difference of the variational
# term's large parts for a term the inducing points represent exactly; the
# same f32 run through autograd is printed beside it.  sm2 as a whole
# (None): sm_init_from_data on bench's 8-d rows gives its second component
# a noise peak of the marginal periodograms near their Nyquist frequency
# (mu of thousands of cycles a unit, lengthscales below 1e-3), where f32
# loses the cosine's phase and the gemm form of sqdist the coincident
# pairs.  sm2-default holds the same family in f32 at its default_params.
F32_NOT_HELD = {"trend": ("terms.1.log_ells",), "sm2": None}
# What the f64 card-vs-CPU check prints but does not hold: sm_init's sm2's
# z gradient sums that component's terms of thousands of cycles a unit
# with signs that cancel, so the order of summation moves it past 1e-8.
F64_NOT_HELD = {"sm2": ("z",)}


def composites_phase(dev, card: str, data) -> None:
    """Each composite model in f32 against its f64 twin on the card (the
    section 2 bounds: evidence 2e-5, each gradient group 1e-3, but for
    F32_NOT_HELD), then in f64 on the card against the CPU over the first
    100,000 rows (evidence 1e-8, each group within max(1e-8, eps kappa),
    but for F64_NOT_HELD);
    no kernel launched; the ICM z gradient's task column exactly 0; the
    median of 5 value+grad times, the peak memory, the SM clock and the
    power draw."""
    _, y32, _ = data
    t0 = time.perf_counter()
    models = composite_models(dev, data)
    log(f"composites: models built in {time.perf_counter() - t0:.2f} s "
        f"(sm_init_from_data over {SM_INIT_ROWS} rows included)")
    sm2 = next(fields for tag, _, fields, *_ in models if tag == "sm2")
    log("composites sm2 init (sm_init_from_data): " + "; ".join(
        f"component {j}: |mu| up to "
        f"{float(sm2[f'terms.{j}.terms.1.mu'].abs().max()):.4g} cycles a "
        f"unit, lengthscales down to "
        f"{float(sm2[f'terms.{j}.terms.0.log_ells'].exp().min()):.4g}"
        for j in range(2)))
    for tag, cls, fields, X, z0, block, variational in models:
        fields64 = {n: t.double() if torch.is_tensor(t) else t
                    for n, t in fields.items()}
        composite_checks(tag, (cls, fields, X, y32, z0, block, variational),
                         (cls, fields64, X.double(), y32.double(),
                          z0.double(), block, variational), dev, card)


def composite_checks(tag, args, args64, dev, card) -> None:
    """One composite model's checks and timing (see composites_phase);
    ``args`` and ``args64`` are its f32 and f64 arguments of
    ``composite_value_and_grad``."""
    cls, fields64, X64, y64, z64, block, variational = args64
    (ev, grads), launches = counted(
        f"composites {tag}", lambda: composite_value_and_grad(*args), ())
    check(f"composites {tag} launches", not any(launches.values()),
          f"{cls.name} launched a kernel: {launches}")
    ev64, grads64 = composite_value_and_grad(*args64)
    rel = (ev - ev64) / abs(ev64)
    not_held = F32_NOT_HELD.get(tag, ())
    if not_held is None:
        not_held = ("evidence", *grads)
    if "evidence" not in not_held:
        check(f"composites {tag} evidence", abs(rel) <= 2e-5,
              f"rel {rel:.3e}")
    errs = []
    for name, err in group_errors(grads, grads64).items():
        if name not in not_held:
            check(f"composites {tag} grad {name}", err <= 1e-3 and bool(
                torch.isfinite(grads[name]).all()), f"rel {err:.3e}")
        errs.append(f"{name} {err:.2e}" + (
            " (not held in f32)" if name in not_held
            and "evidence" not in not_held else ""))
    if tag == "icm":
        nonzero = int((grads["z"][:, D] != 0).sum()
                      + (grads64["z"][:, D] != 0).sum())
        check("composites icm task column", nonzero == 0,
              f"{nonzero} task-column z gradients are not 0")
        errs.append("z task column exactly 0 (f32 and f64)")
    held = ("not held in f32: f64 below" if "evidence" in not_held
            else "held")
    log(f"composites {tag} {cls.name} f32: evidence {ev:.3f} vs f64 twin "
        f"{ev64:.3f} ({held}): evidence rel {rel:+.2e}; grads "
        f"{', '.join(errs)}")
    if tag == "trend":
        _, grads_ad = composite_value_and_grad(*args, "ad")
        log(f"composites {tag} f32 through autograd (grad_impl='ad'), for "
            f"information, not held: grads " + ", ".join(
                f"{n} {e:.2e}" for n, e in group_errors(
                    grads_ad, grads64).items()))
    # f64 on the card against the CPU over the first rows
    n = LOW_RANK_ROWS
    fields_cpu = {k: v.cpu() if torch.is_tensor(v) else v
                  for k, v in fields64.items()}
    gpu = composite_value_and_grad(cls, fields64, X64[:n], y64[:n], z64,
                                   block, variational)
    cpu = composite_value_and_grad(cls, fields_cpu, X64[:n].cpu(),
                                   y64[:n].cpu(), z64.cpu(), block,
                                   variational)
    rel = (gpu[0] - cpu[0]) / abs(cpu[0])
    check(f"composites {tag} card vs CPU evidence", abs(rel) <= 1e-8,
          f"rel {rel:.3e}")
    with torch.no_grad():
        km = cls(**fields_cpu, device="cpu",
                 dtype=torch.float64).k_upper(z64.cpu())
        kappa = float(torch.linalg.cond(
            km + JITTER * torch.eye(km.shape[0], dtype=km.dtype)))
    tol = max(1e-8, EPS64 * kappa)
    errs = group_errors(gpu[1], cpu[1])
    not_held = F64_NOT_HELD.get(tag, ())
    for name, err in errs.items():
        if name not in not_held:
            check(f"composites {tag} card vs CPU grad {name}", err <= tol,
                  f"rel {err:.3e} > {tol:.2e}")
    log(f"composites {tag} f64 on the card vs the CPU over {n} rows: "
        f"evidence rel {rel:+.2e}; grads " + ", ".join(
            f"{name} {err:.2e}" + (" (not held)" if name in not_held
                                   else "") for name, err in errs.items())
        + f" (bound {tol:.2e}: kappa of K(Z, Z) + jitter {kappa:.2e})")
    time_family(f"composites {tag} value+grad f32",
                lambda: composite_value_and_grad(*args), dev, card, block)


# -- hetero: per-row sigma2 on the streaming path (autograd through the
# plain loop)
HETERO_MASKED = 10_000  # every 100th row


def hetero_inputs(dev):
    """Per-row sigma2 0.1 (1 + 0.5 u), u ~ U(0, 1) from default_rng(1), and
    a mask with every 100th row out, on the card in f32."""
    u = np.random.default_rng(1).uniform(size=N)
    noise = torch.as_tensor(SIGMA2 * (1.0 + 0.5 * u), dtype=torch.float32,
                            device=dev)
    mask = torch.ones(N, dtype=torch.float32, device=dev)
    mask[::N // HETERO_MASKED] = 0.0
    return noise, mask


def hetero_value_and_grad(dev, X, y, Z, noise, mask):
    """SE-iso evidence at bench's hypers with per-row noise and the mask,
    through ``stream_stats`` (it streams on the plain loop under
    autograd), and its gradient groups (log_ell, log_sf2, z, the sigma2
    vector), in X's dtype."""
    dt = X.dtype
    kernel = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=dt)
    z = torch.as_tensor(Z, dtype=dt, device=dev).requires_grad_(True)
    s2 = noise.to(dt).clone().requires_grad_(True)
    inducing = calc_inducing(kernel, z, JITTER)
    stats = streaming.stream_stats(kernel, inducing, s2, X, y,
                                   block_size=FAMILY_BLOCK, mask=mask.to(dt))
    ev = streaming.evidence_from_stats(inducing, stats)
    ev.backward()
    return ev.item(), (kernel.log_ell.grad, kernel.log_sf2.grad, z.grad,
                       s2.grad)


def hetero_phase(dev, card: str, data) -> None:
    X32, y32, Z = data
    noise, mask = hetero_inputs(dev)
    (ev, grads), launches = counted("hetero", lambda: hetero_value_and_grad(
        dev, X32, y32, Z, noise, mask), ())
    check("hetero launches", not any(launches.values()),
          f"per-row sigma2 launched a kernel: {launches}")
    ev64, grads64 = hetero_value_and_grad(dev, X32.double(), y32.double(),
                                          Z, noise, mask)
    errs = check_twin("hetero", ev, grads, ev64, grads64,
                      ("log_ell", "log_sf2", "z", "sigma2"))
    masked = int((grads[3][mask == 0] != 0).sum())
    check("hetero masked rows", masked == 0,
          f"{masked} masked rows got a sigma2 gradient")
    log(f"hetero f32 ({HETERO_MASKED} rows masked): evidence {ev:.3f} vs f64 "
        f"twin {ev64:.3f}: {errs}")
    time_family("hetero value+grad f32", lambda: hetero_value_and_grad(
        dev, X32, y32, Z, noise, mask), dev, card)


# -- gaussian_ext: the Gaussian-likelihood extensions (warped, online,
# PITC, Student-t, the exact GP, batched tasks) at bench's draw
F32 = torch.float32
EXT_REPS = 3  # timings: median of 3 after a warm-up
WARP_TERMS = 3
FIT_WARPED_ITERS = 5
ONLINE_BATCHES = 10
PITC_BLOCK = 256
T_NU = 4.0
EXACT_ROWS, EXACT_TEST = 20_000, 100_000
EXACT_M = (100, 300, 1_000, 3_000)  # nested Z: X's first m rows
TASKS, TASK_DENSE_ROWS = 4, 100_000
# the tasks' hypers (log_ell, log_sf2, sigma2); targets: bench's y, then
# three standard-normal draws of default_rng(TASK_SEED)
TASK_HYPERS = ((0.5, 0.0, 0.1), (0.3, 0.1, 0.2), (0.7, -0.1, 0.1),
               (0.5, 0.0, 0.3))
TASK_SEED = 4


def ext_kernel(dev, dtype):
    return SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=dtype)


def grads_of(ev, kernel, *extra):
    """ev.backward(); (ev, the gradients of the kernel's hypers and of each
    of ``extra``)."""
    ev.backward()
    return ev.item(), (kernel.log_ell.grad, kernel.log_sf2.grad,
                       *(t.grad for t in extra))


def leaf(Z, dtype, dev):
    return torch.as_tensor(Z, dtype=dtype, device=dev).clone()\
        .requires_grad_(True)


def warped_value_and_grad(dev, X, y, Z, impl):
    """The warped evidence (SE-iso at bench's hypers, the K = 3 default
    warp, block 8,192, jitter 1e-6) and its gradient groups (log_ell,
    log_sf2, z, sigma2, the warp's log_a | log_b | c) in X's dtype."""
    dt = X.dtype
    k = ext_kernel(dev, dt)
    wp = default_warp_params(WARP_TERMS, device=dev, dtype=dt)
    z, s2 = leaf(Z, dt, dev), leaf(SIGMA2, dt, dev)
    ev = warped_log_evidence(k, wp, z, s2, X, y.to(dt), block_size=BLOCK,
                             jitter=JITTER, impl=impl)
    ev, grads = grads_of(ev, k, z, s2)
    return ev, (*grads, torch.cat([wp.log_a.grad, wp.log_b.grad,
                                   wp.c.grad]))


def ext_time(tag, fn, card, **note) -> float:
    """Median of EXT_REPS calls after a warm-up, logged with the SM clock
    and the power draw (and ``note``)."""
    sampler = clock_log()
    try:
        t0 = time.time()
        ms = median_ms(fn, reps=EXT_REPS)
        t1 = time.time()
    finally:
        samples = read_clock_log(sampler)
    extra = "".join(f"; {k.replace('_', ' ')} {v}" for k, v in note.items())
    log(f"time gaussian_ext {tag}: {ms:.3f} ms (median of {EXT_REPS})"
        f"{extra}; {clock_window(samples, t0, t1)} ({card})")
    return ms


def warped_leg(dev, card, X32, y32, Z) -> None:
    names = ("log_ell", "log_sf2", "z", "sigma2", "warp")
    (ev, grads), launches = counted(
        "gaussian_ext warped", lambda: warped_value_and_grad(
            dev, X32, y32, Z, None), (FWD_KERNEL, BWD_KERNEL))
    check("gaussian_ext warped launches", launches[FWD_KERNEL] == 1
          and launches[BWD_KERNEL] == 1, f"{launches}, want 1 + 1")
    loop = warped_value_and_grad(dev, X32, y32, Z, "reference")
    twin = warped_value_and_grad(dev, X32.double(), y32.double(), Z,
                                 "reference")
    log(f"gaussian_ext warped f32 (#1, #3) vs the f32 plain loop: "
        f"{check_twin('warped vs loop', ev, grads, *loop, names)}")
    log(f"gaussian_ext warped f32 (#1, #3) vs the f64 twin {twin[0]:.3f}: "
        f"{check_twin('warped vs f64', ev, grads, *twin, names)}")
    ext_time("warped value+grad f32 (#1, #3)", lambda: warped_value_and_grad(
        dev, X32, y32, Z, None), card)
    ext_time("warped value+grad f32 plain loop", lambda:
             warped_value_and_grad(dev, X32, y32, Z, "reference"), card)

    # fit_warped on bench's training targets, then the observation-space
    # moments at the 1M training inputs
    yf = bench_targets(dev, X32)
    pack = make_pack(ext_kernel(dev, F32), torch.as_tensor(Z, device=dev),
                     1.0)
    wp0 = default_warp_params(WARP_TERMS, device=dev, dtype=F32)
    pack_w, unpack_w = make_warped_pack(pack, wp0)
    with torch.no_grad():
        k0, z0, s0, w0 = unpack_w(pack_w.x0)
        f0 = -float(warped_log_evidence(k0, w0, z0, s0, X32, yf,
                                        variational=True, block_size=BLOCK,
                                        jitter=JITTER)) / N
    t0 = time.perf_counter()
    (kernel, z, s2, wp, st), launches = counted(
        "gaussian_ext fit_warped", lambda: fit_warped(
            X32, yf, pack, wp0, variational=True, block_size=BLOCK,
            jitter=JITTER, max_iter=FIT_WARPED_ITERS, epsabs=1e-4),
        (FWD_KERNEL, BWD_KERNEL))
    secs = time.perf_counter() - t0
    f = float(st.f)
    log(f"gaussian_ext fit_warped: {st.n_iter} iterations, {st.n_evals} "
        f"evaluations ({launches[FWD_KERNEL]} + {launches[BWD_KERNEL]} "
        f"launches), mean NLL {f0:.6f} -> {f:.6f}, {secs:.2f} s = "
        f"{1e3 * secs / st.n_evals:.1f} ms per evaluation; warp a "
        f"{torch.exp(wp.log_a).tolist()} ({card})")
    check("gaussian_ext fit_warped", st.n_iter >= 1 and np.isfinite(f)
          and f < f0 and launches[FWD_KERNEL] == launches[BWD_KERNEL],
          f"mean NLL {f0} -> {f}, {launches}")
    with torch.no_grad():
        inducing, r_mat, coeffs = streaming.streaming_coeffs(
            kernel, z, s2, X32, warp(wp, yf), jitter=JITTER,
            block_size=BLOCK)
        mu = streaming.predict_means_blocked(kernel, z, coeffs, X32,
                                             block_size=65_536)
        var = streaming.predict_variances_blocked(
            kernel, z, inducing.chol_km, r_mat, X32, s2, block_size=65_536)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m1, v1 = warped_predict_moments(wp, mu, torch.clamp(var, min=0.0))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    ok = bool(torch.isfinite(m1).all() and torch.isfinite(v1).all()
              and (v1 >= 0).all())
    log(f"gaussian_ext warped_predict_moments: {N} points x 20 nodes in "
        f"{1e3 * secs:.1f} ms, finite {ok}; mean |E[y*] - g^-1(mu)| "
        f"{float((m1 - warp_inv(wp, mu)).abs().mean()):.3e} ({card})")
    check("gaussian_ext warped_predict_moments", ok, "non-finite moments")


def online_leg(dev, card, X32, y32, Z) -> None:
    """1M rows in ONLINE_BATCHES batches through online_update (block
    8,192), the last one downdated; held against the streaming evidence
    and coefficients of the rows that remain, in f64."""
    k32, z32 = ext_kernel(dev, F32), torch.as_tensor(Z, device=dev)
    rows = N // ONLINE_BATCHES

    def run():
        times = []
        with torch.no_grad():
            st = online_init(k32, z32, SIGMA2, jitter=JITTER)
            for i in range(ONLINE_BATCHES):
                t0 = time.perf_counter()
                st = online_update(k32, st, X32[i * rows:(i + 1) * rows],
                                   y32[i * rows:(i + 1) * rows],
                                   block_size=BLOCK)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            st = online_downdate(k32, st, X32[-rows:], y32[-rows:],
                                 block_size=BLOCK)
            torch.cuda.synchronize()
        return st, times, 1e3 * (time.perf_counter() - t0)

    (st, times, down_ms), launches = counted("gaussian_ext online", run,
                                             (FWD_KERNEL,))
    check("gaussian_ext online launches", launches[FWD_KERNEL]
          == ONLINE_BATCHES + 1 and launches[BWD_KERNEL] == 0,
          f"{launches}, want {ONLINE_BATCHES + 1} + 0")
    keep = N - rows
    k64, z64 = ext_kernel(dev, torch.float64), z32.double()
    X64, y64 = X32[:keep].double(), y32[:keep].double()
    with torch.no_grad():
        ev = float(online_log_evidence(st))
        mp, _ = online_predictors(st)
        ev64 = float(streaming.streaming_log_evidence(
            k64, z64, SIGMA2, X64, y64, jitter=JITTER, block_size=BLOCK,
            impl="reference"))
        _, _, c64 = streaming.streaming_coeffs(
            k64, z64, SIGMA2, X64, y64, jitter=JITTER, block_size=BLOCK,
            impl="reference")
    rel, crel = (ev - ev64) / abs(ev64), rel_norm(mp.coeffs, c64)
    n_live = float(st.stats.n + st.stats_lo.n)
    log(f"gaussian_ext online: {ONLINE_BATCHES} updates of {rows} rows "
        f"({statistics.median(times):.2f} ms median, {min(times):.2f}-"
        f"{max(times):.2f}), 1 downdate ({down_ms:.2f} ms); {n_live:.0f} "
        f"rows live; evidence {ev:.3f} vs the f64 streaming twin on them "
        f"{ev64:.3f} (rel {rel:+.2e}), coefficients rel {crel:.2e} "
        f"({card})")
    check("gaussian_ext online", abs(rel) <= 2e-5 and crel <= 1e-3
          and n_live == keep, f"evidence rel {rel:.3e}, coeffs {crel:.3e}, "
          f"{n_live} rows")


def pitc_value_and_grad(dev, X, y, Z):
    dt = X.dtype
    k = ext_kernel(dev, dt)
    z, s2 = leaf(Z, dt, dev), leaf(SIGMA2, dt, dev)
    ev = pitc_log_evidence(k, z, s2, X, y.to(dt), block_size=PITC_BLOCK,
                           jitter=JITTER)
    return grads_of(ev, k, z, s2)


def pitc_leg(dev, card, X32, y32, Z) -> None:
    names = ("log_ell", "log_sf2", "z", "sigma2")
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    (ev, grads), launches = counted("gaussian_ext pitc", lambda:
                                    pitc_value_and_grad(dev, X32, y32, Z),
                                    ())
    peak = torch.cuda.max_memory_allocated(dev) - base
    check("gaussian_ext pitc launches", not any(launches.values()),
          f"{launches}")
    twin = pitc_value_and_grad(dev, X32.double(), y32.double(), Z)
    log(f"gaussian_ext pitc f32 (block {PITC_BLOCK}) vs the f64 twin "
        f"{twin[0]:.3f}: {check_twin('pitc vs f64', ev, grads, *twin, names)}")
    ext_time(f"pitc value+grad f32 block {PITC_BLOCK}", lambda:
             pitc_value_and_grad(dev, X32, y32, Z), card,
             peak_memory=f"{peak / 2**20:.1f} MiB above the data")


def robust_m_step(dev, X, y, Z, lam):
    """bench.py's student-t M-step: the dense evidence with noise 0.1 / lam
    and its gradient groups (log_ell, log_sf2, z), in X's dtype."""
    dt = X.dtype
    k = ext_kernel(dev, dt)
    z = leaf(Z, dt, dev)
    ev = log_evidence(k, z, SIGMA2 / lam.to(dt), X, y.to(dt), jitter=JITTER)
    return grads_of(ev, k, z)


def robust_leg(dev, card, X32, y32, Z) -> None:
    k32, z32 = ext_kernel(dev, F32), torch.as_tensor(Z, device=dev)

    def e_step():
        with torch.no_grad():
            return t_em_sweeps(k32, z32, SIGMA2, X32, y32, nu=T_NU, sweeps=1,
                               jitter=JITTER)[0]

    lam = e_step()
    (ev, grads), launches = counted("gaussian_ext robust", lambda:
                                    robust_m_step(dev, X32, y32, Z, lam), ())
    check("gaussian_ext robust launches", not any(launches.values()),
          f"{launches}")
    twin = robust_m_step(dev, X32.double(), y32.double(), Z, lam)
    log(f"gaussian_ext robust: one E-step sweep, lam in "
        f"[{float(lam.min()):.4f}, {float(lam.max()):.4f}]; the dense "
        f"M-step f32 vs the f64 twin {twin[0]:.3f}: "
        f"{check_twin('robust vs f64', ev, grads, *twin, names=('log_ell', 'log_sf2', 'z'))}")
    ext_time("student-t E-step sweep f32 (dense)", e_step, card)
    ext_time("student-t M-step value+grad f32 (dense)", lambda:
             robust_m_step(dev, X32, y32, Z, lam), card)

    # fit_t streaming on the per-row sigma2 path (the plain loop)
    yf = bench_targets(dev, X32)
    pack = make_pack(ext_kernel(dev, F32), z32, SIGMA2)
    t0 = time.perf_counter()
    *_, lam_hat, st = fit_t(X32, yf, pack, nu=T_NU, n_em=2, m_step_iters=3,
                            block_size=16_384, jitter=JITTER, epsabs=1e-4)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    top = (T_NU + 1.0) / T_NU
    ok = bool(torch.isfinite(lam_hat).all() and (lam_hat > 0).all()
              and (lam_hat <= top).all())
    log(f"gaussian_ext fit_t (block 16384, 2 EM rounds of 3 iterations, "
        f"epsabs 1e-4): "
        f"{secs:.2f} s; last M-step {st.n_iter} iterations, {st.n_evals} "
        f"evaluations, mean NLL {float(st.f):.6f}; lam_hat in "
        f"[{float(lam_hat.min()):.4f}, {float(lam_hat.max()):.4f}] (bound "
        f"(nu+1)/nu = {top}), {int((lam_hat < 0.1).sum())} rows below 0.1 "
        f"({card})")
    check("gaussian_ext fit_t", ok, "lam_hat not finite in (0, (nu+1)/nu]")


def titsias_bound(kernel, z, X, y, sigma2) -> float:
    """Titsias' collapsed variational bound log N(y; 0, Q + sigma2 I) -
    sum(r) / (2 sigma2), Q = Knm (Km + jitter I)^-1 Kmn and r = diag(K -
    Q), by the Woodbury identity: a lower bound of the exact evidence that
    rises as inducing rows are added (Titsias 2009)."""
    n = X.shape[0]
    v = solve_tri_right(kernel.k_cross(X, z),
                        cholesky_upper(kernel.k_upper(z), JITTER))
    r = kernel.k_diag(X) - torch.sum(v * v, dim=1)
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    c = cholesky_upper(eye + v.T @ v / sigma2, 0.0)
    w = torch.linalg.solve_triangular(c.T, (v.T @ y)[:, None],
                                      upper=False)[:, 0]
    log_det = n * math.log(sigma2) + 2.0 * torch.sum(torch.log(torch.diag(c)))
    quad = (torch.dot(y, y) - torch.dot(w, w) / sigma2) / sigma2
    return float(-0.5 * (log_det + quad + n * math.log(2.0 * math.pi))
                 - torch.sum(r) / (2.0 * sigma2))


def exact_leg(dev, card, X32, yf) -> None:
    """bench's first EXACT_ROWS rows in f64: the exact evidence and LOO
    objective with their gradients, Titsias' bound below it and rising at
    each m of EXACT_M, and serving at EXACT_TEST points."""
    X, y = X32[:EXACT_ROWS].double(), yf[:EXACT_ROWS].double()
    f64 = torch.float64

    def value_and_grad(obj):
        k = ext_kernel(dev, f64)
        s2 = leaf(SIGMA2, f64, dev)
        return grads_of(obj(k, X, y, s2), k, s2)

    for tag, obj in (("evidence", log_evidence_exact),
                     ("LOO", loo_objective_exact)):
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        val, grads = value_and_grad(obj)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        finite = np.isfinite(val) and all(bool(torch.isfinite(g))
                                          for g in grads)
        log(f"gaussian_ext exact {tag} value+grad f64 at {EXACT_ROWS} rows: "
            f"{val:.4f}, grads (log_ell, log_sf2, sigma2) "
            f"{[round(float(g), 4) for g in grads]}; {1e3 * secs:.1f} ms, "
            f"peak {peak / 2**30:.2f} GiB above the data ({card})")
        check(f"gaussian_ext exact {tag}", finite, "not finite")
        if tag == "evidence":
            exact = val
    k = ext_kernel(dev, f64)
    with torch.no_grad():
        bounds = [titsias_bound(k, X[:m], X, y, SIGMA2) for m in EXACT_M]
        fitc_var = [float(log_evidence(k, X[:m], SIGMA2, X, y,
                                       variational=True, jitter=JITTER,
                                       factorization="chol"))
                    for m in EXACT_M]
    slack = 1e-9 * abs(exact)
    log(f"gaussian_ext exact {exact:.3f} vs Titsias' bound (Z = the first m "
        f"rows): " + ", ".join(f"m {m}: {b:.3f}" for m, b in
                               zip(EXACT_M, bounds))
        + "; the library's variational FITC evidence (FITC's diagonal in "
        "its noise, not a bound): " + ", ".join(
            f"m {m}: {b:.3f}" for m, b in zip(EXACT_M, fitc_var))
        + f" ({card})")
    check("gaussian_ext exact bound", all(b <= exact + slack for b in bounds)
          and all(b1 <= b2 + slack for b1, b2 in zip(bounds, bounds[1:])),
          f"bounds {bounds} against {exact}")
    with torch.no_grad():
        tr = exact_trained(calc_exact(k, X, SIGMA2), y)
        Xs = X32[EXACT_ROWS:EXACT_ROWS + EXACT_TEST].double()
        rows = cli.EXACT_SERVE_ROWS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means = torch.cat([predict_means_exact(k, tr, Xs[i:i + rows])
                           for i in range(0, EXACT_TEST, rows)])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        var = torch.cat([predict_variances_exact(k, tr, Xs[i:i + rows])
                         for i in range(0, EXACT_TEST, rows)])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        # the training-input identity mu(X) = y - sigma2 alpha
        ident = rel_norm(predict_means_exact(k, tr, X[:rows]),
                         y[:rows] - SIGMA2 * tr.alpha[:rows])
    ok = bool(torch.isfinite(means).all() and (var > 0).all())
    log(f"gaussian_ext exact serving: {EXACT_TEST} means {1e3 * (t1 - t0):.1f}"
        f" ms, variances {1e3 * (t2 - t1):.1f} ms ({rows} rows a block), "
        f"finite and positive {ok}; mu(X) vs y - sigma2 alpha rel "
        f"{ident:.2e} ({card})")
    check("gaussian_ext exact serving", ok and ident <= 1e-8,
          f"finite {ok}, identity {ident:.3e}")


def task_value_and_grad(dev, X, y, Z, hypers, impl):
    """One task's streaming value+grad (log_ell, log_sf2, z, sigma2)."""
    dt = X.dtype
    log_ell, log_sf2, sigma2 = hypers
    k = SeIso(log_ell, log_sf2, device=dev, dtype=dt)
    z, s2 = leaf(Z, dt, dev), leaf(sigma2, dt, dev)
    ev = streaming.streaming_log_evidence(k, z, s2, X, y.to(dt),
                                          jitter=JITTER, block_size=BLOCK,
                                          impl=impl)
    return grads_of(ev, k, z, s2)


def multitask_leg(dev, card, X32, y32, Z) -> None:
    names = ("log_ell", "log_sf2", "z", "sigma2")
    draws = np.random.default_rng(TASK_SEED).standard_normal(
        (TASKS - 1, N)).astype(np.float32)
    Y = torch.cat([y32[None], torch.as_tensor(draws, device=dev)])
    hyp = np.array(TASK_HYPERS, dtype=np.float32)
    k = SeIso(hyp[:, 0], hyp[:, 1], device=dev, dtype=F32)
    s2 = torch.as_tensor(hyp[:, 2], device=dev)
    zs = torch.as_tensor(Z, device=dev).expand(TASKS, M, D)
    vg = batched_value_and_grad(block_size=BLOCK, jitter=JITTER)
    (vals, (gp, gz, gs)), launches = counted(
        "gaussian_ext multitask", lambda: vg(k, zs, s2, X32.expand(
            TASKS, N, D), Y), (FWD_KERNEL, BWD_KERNEL))
    check("gaussian_ext multitask launches", launches[FWD_KERNEL] == TASKS
          and launches[BWD_KERNEL] == TASKS,
          f"{launches}, want {TASKS} + {TASKS}")
    for i, hypers in enumerate(TASK_HYPERS):
        got = (-vals[i].item(), (-gp["log_ell"][i], -gp["log_sf2"][i],
                                 -gz[i], -gs[i]))
        loop = task_value_and_grad(dev, X32, Y[i], Z, hypers, "reference")
        twin = task_value_and_grad(dev, X32.double(), Y[i], Z, hypers,
                                   "reference")
        log(f"gaussian_ext multitask task {i} {hypers}: vs its f32 plain "
            f"loop {check_twin(f'task {i} vs loop', *got, *loop, names)}; vs"
            f" its f64 twin {check_twin(f'task {i} vs f64', *got, *twin, names)}")
    ext_time(f"multitask streaming value+grad f32, {TASKS} tasks (#1, #3 "
             f"each)", lambda: vg(k, zs, s2, X32.expand(TASKS, N, D), Y),
             card)

    # the dense branch: the tasks under torch.func.vmap
    rows = TASK_DENSE_ROWS
    vd = batched_value_and_grad(jitter=JITTER)
    args = (k, zs, s2, X32[:rows].expand(TASKS, rows, D), Y[:, :rows])
    vals, (gp, gz, gs) = vd(*args)
    for i, (log_ell, log_sf2, sigma2) in enumerate(TASK_HYPERS):
        k64 = SeIso(log_ell, log_sf2, device=dev, dtype=torch.float64)
        z, s2_i = leaf(Z, torch.float64, dev), leaf(sigma2, torch.float64,
                                                    dev)
        ev = log_evidence(k64, z, s2_i, X32[:rows].double(),
                          Y[i, :rows].double(), jitter=JITTER,
                          factorization="chol")
        twin = grads_of(ev, k64, z, s2_i)
        got = (-vals[i].item(), (-gp["log_ell"][i], -gp["log_sf2"][i],
                                 -gz[i], -gs[i]))
        log(f"gaussian_ext multitask dense ({rows} rows) task {i} vs its f64"
            f" twin: {check_twin(f'dense task {i} vs f64', *got, *twin, names)}")
    ext_time(f"multitask dense value+grad f32, {TASKS} tasks x {rows} rows "
             f"(vmap)", lambda: vd(*args), card)


def gaussian_ext_phase(dev, card: str, data) -> None:
    X32, y32, Z = data
    t0 = time.perf_counter()
    for leg in (warped_leg, online_leg, pitc_leg, robust_leg):
        t1 = time.perf_counter()
        leg(dev, card, X32, y32, Z)
        log(f"gaussian_ext {leg.__name__}: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    exact_leg(dev, card, X32, bench_targets(dev, X32))
    log(f"gaussian_ext exact_leg: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    multitask_leg(dev, card, X32, y32, Z)
    log(f"gaussian_ext multitask_leg: {time.perf_counter() - t1:.1f} s")
    log(f"gaussian_ext phase: {time.perf_counter() - t0:.1f} s ({card})")


# -- laplace: the Laplace likelihood families (bench.py:565-585, 757-775)
LAPLACE_STEPS = 15  # bench's classify and ordinal legs
LAPLACE_ROWS = 100_000  # streaming legs, gradient routes, fits, predictions
LAPLACE_FIT_ITERS = 5
LAPLACE_SEED = 5  # the counts' numpy draw
# the streaming legs take seconds an evaluation: timed once after the
# warm-up (the script's time limit)
LAPLACE_STREAM_REPS = 1
NB_R = 2.0  # the NB2 dispersion of the draw and of the evaluation
ORD_EDGES = (-1.0, 0.0, 1.0)  # bench's ordinal labels: K = 4
ORD_CUT_RAW = (-1.0, 0.0, 0.0)
# What f32 cannot resolve, by leg: printed against the f64 twin, held in
# f64 card vs CPU over LAPLACE_ROWS (as F32_NOT_HELD in composites).  The
# dense Poisson at 1M rows: its log_ell and z gradients (1.6e-3 and
# 1.4e-2 of the f64 twin) sum autograd's f32 products over all 10^6 rows
# in one reduction (V's and K's backward), with Poisson's curvature W up to
# e^3 against the logit's 1/4; the streaming legs, whose products sum
# 8,192-row blocks, hold the bounds.
LAPLACE_F32_NOT_HELD = {"poisson dense": ("log_ell", "z")}


def laplace_data(dev, X32, y32):
    """bench's classify labels sign(y) + (y == 0), then from
    default_rng(LAPLACE_SEED) over the latent sin(x0 + x1): Poisson counts
    at rate exp(latent), binomial successes of 1..5 trials at
    sigmoid(latent), NB2 counts of mean exp(latent) and dispersion NB_R;
    bench's ordinal labels digitize(x0 + x1, ORD_EDGES).  On the card, f32
    (the ordinal labels int64)."""
    yc = torch.sign(y32) + (y32 == 0).to(torch.float32)
    s = (X32[:, 0] + X32[:, 1]).cpu().numpy().astype(np.float64)
    latent = np.sin(s)
    rng = np.random.default_rng(LAPLACE_SEED)
    counts = rng.poisson(np.exp(latent))
    trials = rng.integers(1, 6, N)
    succ = rng.binomial(trials, 1.0 / (1.0 + np.exp(-latent)))
    nb = rng.negative_binomial(NB_R, NB_R / (NB_R + np.exp(latent)))
    yo = np.digitize(s, ORD_EDGES)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return {"classify": yc, "poisson": f32(counts),
            "binomial": (f32(succ), f32(trials)), "negbin": f32(nb),
            "ordinal": torch.as_tensor(yo, dtype=torch.int64, device=dev)}


def laplace_model(name, labels, steps=LAPLACE_STEPS):
    """(evidence fn(kernel, z, X, extra, block_size, grad_impl), the start
    of the likelihood's leaf or None) of a Laplace model on ``labels``
    (cast to X's dtype where float)."""
    def cast(t, X):
        return t.to(X.dtype) if t.is_floating_point() else t

    if name == "classify":
        return (lambda k, z, X, e, bs, gi: classify_log_evidence(
            k, z, X, cast(labels, X), newton_iters=steps, jitter=JITTER,
            block_size=bs, grad_impl=gi)), None
    if name == "poisson":
        return (lambda k, z, X, e, bs, gi: poisson_log_evidence(
            k, z, X, cast(labels, X), newton_iters=steps, jitter=JITTER,
            block_size=bs, grad_impl=gi)), None
    if name == "binomial":
        succ, trials = labels
        return (lambda k, z, X, e, bs, gi: binomial_log_evidence(
            k, z, X, cast(succ, X), cast(trials, X), newton_iters=steps,
            jitter=JITTER, block_size=bs, grad_impl=gi)), None
    if name == "negbin":
        return (lambda k, z, X, e, bs, gi: negbin_log_evidence(
            k, z, X, cast(labels, X), e, newton_iters=steps, jitter=JITTER,
            block_size=bs, grad_impl=gi)), NB_R
    return (lambda k, z, X, e, bs, gi: ordinal_log_evidence(
        k, z, X, labels, e, newton_iters=steps, jitter=JITTER,
        block_size=bs, grad_impl=gi)), ORD_CUT_RAW


def laplace_rows(labels, rows):
    if isinstance(labels, tuple):
        return tuple(t[:rows] for t in labels)
    return labels[:rows]


def laplace_value_and_grad(name, labels, X, Z, block=None, grad_impl="ift"):
    """The model's evidence at bench's SE-iso hypers (jitter 1e-6) and its
    gradient groups (log_ell, log_sf2, z and the likelihood's leaf), in X's
    dtype on X's device."""
    fn, e0 = laplace_model(name, labels)
    dev, dt = X.device, X.dtype
    k = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=dt)
    z = leaf(Z, dt, dev)
    e = leaf(e0, dt, dev) if e0 is not None else None
    ev = fn(k, z, X, e, block, grad_impl)
    ev, grads = grads_of(ev, k, z, *([e] if e is not None else []))
    return ev, grads


def laplace_names(name):
    extra = {"negbin": ("r",), "ordinal": ("cut_raw",)}.get(name, ())
    return ("log_ell", "log_sf2", "z") + extra


def classify_bound(n, d, m, steps) -> dict:
    """Bench's classify leg, value and gradient, dense: per Newton step the
    Woodbury Gram (2 n m^2), one more for the evidence's factor and one for
    the IFT backward's, V = Knm U^-1 and its two backward products
    (2 n m^2 each), Knm and its pullback (~4 n m d); X, y and z read, the
    evidence and the gradients written."""
    flops = (steps + 5) * 2.0 * n * m * m + 4.0 * n * m * d
    return bound(flops, 4.0 * (n * (d + 1) + 2 * m * d + 2))


def laplace_time(tag, fn, dev, card, reps=5, note="", prefix="laplace",
                 b=None) -> float:
    """Median of ``reps`` after a warm-up, the peak memory above what was
    allocated before, the SM clock and the power draw (beside the bound
    ``b`` where given)."""
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    sampler = clock_log()
    try:
        t0 = time.time()
        ms = median_ms(fn, reps=reps)
        t1 = time.time()
    finally:
        samples = read_clock_log(sampler)
    peak = torch.cuda.max_memory_allocated(dev) - base
    if b is not None:
        note += (f"; bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
                 f"{ms / b['bound_ms']:.1f}x")
    log(f"time {prefix} {tag}: {ms:.3f} ms (median of {reps}){note}; peak "
        f"memory {peak / 2**30:.2f} GiB above the data; "
        f"{clock_window(samples, t0, t1)} ({card})")
    return ms


def f64_card_vs_cpu(prefix, tag, vg, names, labels, X32, Z, groups) -> str:
    """What f32 cannot resolve, held in f64 card vs CPU over LAPLACE_ROWS
    rows: the evidence of ``vg(labels, X, Z) -> (evidence, gradients)``
    within 1e-8 relative and the named groups (every group where
    ``groups`` is empty) within 1e-8 (2-norm)."""
    rows = laplace_rows(labels, LAPLACE_ROWS)
    X = X32[:LAPLACE_ROWS].double()
    card = vg(rows, X, Z)
    cpu_rows = (tuple(t.cpu() for t in rows) if isinstance(rows, tuple)
                else rows.cpu())
    cpu = vg(cpu_rows, X.cpu(), Z)
    rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    check(f"{prefix} {tag} f64 card vs cpu evidence", rel <= 1e-8,
          f"rel {rel:.3e}")
    errs = [f"evidence {rel:.2e}"]
    for g_name, g, w in zip(names, card[1], cpu[1]):
        err = rel_norm(g.cpu(), w)
        if not groups or g_name in groups:
            check(f"{prefix} {tag} f64 card vs cpu {g_name}", err <= 1e-8,
                  f"rel {err:.3e}")
        errs.append(f"{g_name} {err:.2e}")
    return ", ".join(errs)


def vs_twin(prefix, tag, vg, names, labels, X32, Z, dev, card, not_held,
            reps=5, b=None) -> tuple:
    """One leg, ``vg(labels, X, Z) -> (evidence, gradients)``, in f32 (no
    kernel launched) against its f64 twin on the card: the section 2
    bounds (evidence 2e-5, each group 1e-3) but for the groups of
    ``not_held[tag]``, held in f64 card vs CPU; then timed.  Returns the
    twin's (evidence, gradients)."""
    (ev, grads), _ = counted(f"{prefix} {tag}", lambda: vg(labels, X32, Z),
                             ())
    check(f"{prefix} {tag} launches", all(
        w.launches == 0 for w in WRAPPERS.values()), "a kernel launched")
    twin = vg(labels, X32.double(), Z)
    rel = (ev - twin[0]) / abs(twin[0])
    loose = not_held.get(tag, ())
    errs = []
    check(f"{prefix} {tag} evidence", abs(rel) <= 2e-5, f"rel {rel:.3e}")
    for g_name, g, w in zip(names, grads, twin[1]):
        err = rel_norm(g, w)
        if g_name not in loose:
            check(f"{prefix} {tag} grad {g_name}", err <= 1e-3
                  and bool(torch.isfinite(g).all()), f"rel {err:.3e}")
        errs.append(f"{g_name} {err:.2e}")
    log(f"{prefix} {tag} f32 vs the f64 twin {twin[0]:.3f}: evidence rel "
        f"{rel:+.2e}; grads {', '.join(errs)} ({card})")
    if tag in not_held:
        log(f"{prefix} {tag} not held in f32 ({loose}); f64 card vs cpu over "
            f"{LAPLACE_ROWS} rows: "
            + f64_card_vs_cpu(prefix, tag, vg, names, labels, X32, Z, loose))
    laplace_time(f"{tag} value+grad f32", lambda: vg(labels, X32, Z), dev,
                 card, reps, prefix=prefix, b=b)
    return twin


def laplace_vs_twin(tag, name, labels, X32, Z, block, dev, card,
                    reps=5) -> tuple:
    """``vs_twin`` of a Laplace model, LAPLACE_F32_NOT_HELD its loose
    groups."""
    return vs_twin("laplace", tag, lambda lab, X, Z: laplace_value_and_grad(
        name, lab, X, Z, block), laplace_names(name), labels, X32, Z, dev,
        card, LAPLACE_F32_NOT_HELD, reps)


def laplace_ablation(tag, name, labels, X32, Z, twin, card) -> None:
    """For information, not held: a dense leg's f32 value and gradient with
    one design choice of ``models/ift.py`` undone, against its f64 twin:
    the Newton steps and the IFT backward's solve in f32
    (``ift.MODE_DTYPE``, the JAX package's choice) and each product
    summed over the rows as one product (``ift.REDUCE_ROWS``)."""
    for what, attr, value in (
            ("Newton steps and IFT solve in f32", "MODE_DTYPE",
             torch.float32),
            ("one product over all rows", "REDUCE_ROWS", 1 << 62)):
        kept = getattr(ift, attr)
        setattr(ift, attr, value)
        try:
            ev, grads = laplace_value_and_grad(name, labels, X32, Z, None)
        finally:
            setattr(ift, attr, kept)
        errs = ", ".join(f"{g_name} {rel_norm(g, w):.2e}" for g_name, g, w
                         in zip(laplace_names(name), grads, twin[1]))
        log(f"laplace ablation {tag}, {what}: evidence rel "
            f"{(ev - twin[0]) / abs(twin[0]):+.2e}; grads {errs} ({card})")


def laplace_ift_vs_unroll(dev, card, X32, Z, labels) -> None:
    """The two gradient routes in f64 at LAPLACE_ROWS rows, dense and
    streaming: the evidence within 1e-9 and each gradient group within
    1e-6 (JAX's tests/test_ift.py bound)."""
    X = X32[:LAPLACE_ROWS].double()
    for name in ("classify", "ordinal"):
        rows = laplace_rows(labels[name], LAPLACE_ROWS)
        for block in (None, BLOCK):
            ift = laplace_value_and_grad(name, rows, X, Z, block, "ift")
            t0 = time.perf_counter()
            unroll = laplace_value_and_grad(name, rows, X, Z, block,
                                            "unroll")
            secs = time.perf_counter() - t0
            rel = abs(ift[0] - unroll[0]) / abs(unroll[0])
            tag = f"laplace ift vs unroll {name} block={block}"
            check(f"{tag} evidence", rel <= 1e-9, f"rel {rel:.3e}")
            errs = []
            for g_name, g, w in zip(laplace_names(name), ift[1], unroll[1]):
                err = rel_norm(g, w)
                check(f"{tag} {g_name}", err <= 1e-6, f"rel {err:.3e}")
                errs.append(f"{g_name} {err:.2e}")
            log(f"{tag} (f64, {LAPLACE_ROWS} rows): evidence {rel:.2e}; "
                f"{', '.join(errs)}; unroll {secs:.2f} s ({card})")


def laplace_fits(dev, card, X32, Z, labels) -> None:
    """fit_classify (on the labels sign(yf) of the fit phase's targets:
    bench's classify labels are noise), fit_poisson and fit_ordinal,
    LAPLACE_FIT_ITERS iterations in f32 on the first LAPLACE_ROWS rows from
    bench's hypers (z = Z), the line search's curvature window 0.9 (as
    classify_ext_fits): finite, and the mean NLL falls."""
    X = X32[:LAPLACE_ROWS]
    yf = bench_targets(dev, X32)[:LAPLACE_ROWS]
    for name in ("classify", "poisson", "ordinal"):
        rows = (torch.where(yf > 0, 1.0, -1.0) if name == "classify"
                else laplace_rows(labels[name], LAPLACE_ROWS))
        k = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float32)
        pack = make_pack(k, torch.as_tensor(Z, device=dev), 1.0,
                         learn_sigma2=False)
        # tol 0.9: at the default 0.1 fit_ordinal took 73 evaluations for
        # 5 iterations (44.8 s of the phase's 205 s)
        kw = dict(max_iter=LAPLACE_FIT_ITERS, newton_iters=LAPLACE_STEPS,
                  jitter=JITTER, epsabs=1e-6, tol=0.9)
        t0 = time.perf_counter()
        if name == "classify":
            out = fit_classify(X, rows, pack, **kw)
        elif name == "poisson":
            out = fit_poisson(X, rows, pack, **kw)
        else:
            cut0 = torch.tensor(ORD_CUT_RAW, device=dev)
            out = fit_ordinal(X, rows, pack, cut0, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = out[-1]
        fn, e0 = laplace_model(name, rows)
        with torch.no_grad():
            e = (torch.tensor(e0, device=dev) if e0 is not None else None)
            f0 = -float(fn(k, torch.as_tensor(Z, device=dev), X, e, None,
                           "ift")) / LAPLACE_ROWS
        f1 = float(st.f)
        log(f"laplace fit_{name}: {int(st.n_iter)} iterations, "
            f"{int(st.n_evals)} evaluations in {secs:.2f} s "
            f"({1e3 * secs / max(int(st.n_evals), 1):.1f} ms each); mean "
            f"NLL {f0:.6f} -> {f1:.6f} ({card})")
        check(f"laplace fit_{name}", math.isfinite(f1) and f1 < f0,
              f"mean NLL {f0} -> {f1}")


def laplace_predict(dev, card, X32, Z, labels) -> None:
    """classify_predict and stream_classify_predict (block 8,192) in f32:
    trained on the first LAPLACE_ROWS rows, served at the next
    LAPLACE_ROWS: probabilities in (0, 1), the two within 1e-5."""
    X = X32[:LAPLACE_ROWS]
    Xs = X32[LAPLACE_ROWS:2 * LAPLACE_ROWS]
    yc = labels["classify"][:LAPLACE_ROWS]
    k = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float32)
    z = torch.as_tensor(Z, device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        dense = classify_predict(k, z, X, yc, Xs, newton_iters=LAPLACE_STEPS,
                                 jitter=JITTER)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stream = stream_classify_predict(k, z, X, yc, Xs, block_size=BLOCK,
                                         newton_iters=LAPLACE_STEPS,
                                         jitter=JITTER)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    p, ps = dense[0], stream[0]
    diff = float(torch.max(torch.abs(p - ps)))
    inside = bool(((p > 0) & (p < 1) & (ps > 0) & (ps < 1)).all())
    log(f"laplace predict: {Xs.shape[0]} points, dense {1e3 * (t1 - t0):.1f}"
        f" ms, streaming {1e3 * (t2 - t1):.1f} ms; probabilities in (0, 1) "
        f"{inside}, max |dense - streaming| {diff:.2e}, mean prob "
        f"{float(p.mean()):.4f} ({card})")
    check("laplace predict", inside and diff <= 1e-5,
          f"in (0, 1) {inside}, diff {diff:.3e}")


def laplace_phase(dev, card: str, data) -> None:
    """Bench's classify leg (dense and streaming at 1M, f32 against the f64
    twin, timed with its bound), the count families and ordinal (dense at
    1M, streaming at LAPLACE_ROWS), IFT against unroll, three fits and the
    classifier's predictions; no kernel launches on any of them."""
    X32, y32, Z = data
    t0 = time.perf_counter()
    labels = laplace_data(dev, X32, y32)
    b = classify_bound(N, D, M, LAPLACE_STEPS)
    log(f"laplace bound: bench's classify leg {b['bound_ms']:.3f} ms "
        f"({b['bound_by']}; {LAPLACE_STEPS} + 2 Woodbury Grams and V's "
        f"three products of 2 n m^2)")
    twin = laplace_vs_twin("classify dense", "classify", labels["classify"],
                           X32, Z, None, dev, card)
    laplace_ablation("classify dense", "classify", labels["classify"], X32,
                     Z, twin, card)
    laplace_vs_twin("classify stream", "classify", labels["classify"], X32,
                    Z, BLOCK, dev, card, reps=LAPLACE_STREAM_REPS)
    for name in ("poisson", "binomial", "negbin", "ordinal"):
        twin = laplace_vs_twin(f"{name} dense", name, labels[name], X32, Z,
                               None, dev, card, reps=EXT_REPS)
        if name == "poisson":
            laplace_ablation("poisson dense", name, labels[name], X32, Z,
                             twin, card)
        rows = laplace_rows(labels[name], LAPLACE_ROWS)
        laplace_vs_twin(f"{name} stream {LAPLACE_ROWS}", name, rows,
                        X32[:LAPLACE_ROWS], Z, BLOCK, dev, card,
                        reps=LAPLACE_STREAM_REPS)
    _, launches = counted("laplace fits and predictions", lambda: (
        laplace_ift_vs_unroll(dev, card, X32, Z, labels),
        laplace_fits(dev, card, X32, Z, labels),
        laplace_predict(dev, card, X32, Z, labels)), ())
    check("laplace launches", not any(launches.values()),
          f"{launches}, want all 0")
    log(f"laplace phase: {time.perf_counter() - t0:.1f} s ({card})")


# -- classify_ext: EP and the softmax Laplace (multi-class)
EP_SWEEPS = 20  # bench.py's EP leg
MC_STEPS = 8  # bench.py's multi-class leg
# the gradient routes agree at a fixed point: sites and mode converged
EP_ROUTE_SWEEPS, MC_ROUTE_STEPS = 40, 20
MC_EDGES = (-0.8, 0.8)  # bench's multi-class labels digitize(x0 + x1): C = 3
MC_CLASSES = len(MC_EDGES) + 1
MC_FIT_EDGES = (-0.5, 0.5)  # the fits' labels digitize(yf): noisy, C = 3
GROUPS = ("log_ell", "log_sf2", "z")
EXT_FIT_ITERS = 5
# What f32 cannot resolve in the classify_ext legs, by leg: printed against
# the f64 twin, held in f64 card vs CPU over LAPLACE_ROWS rows.  Bench's EP leg
# at 1M rows: its log-lengthscale gradient (3.5e-3 of the f64 twin) comes
# from the f32 prior itself, V = Knm U^-1 and d = kdiag - rowsq(V): with
# the sweeps and the evidence in f64 on the same f32 V it misses as far
# (``ep_f64_on_f32``'s line).
CLASSIFY_EXT_F32_NOT_HELD = {"ep dense": ("log_ell",)}


def multi_labels(X):
    """bench.py's multi-class labels: digitize(x0 + x1, MC_EDGES), int64 on
    X's device."""
    s = (X[:, 0] + X[:, 1]).cpu().numpy()
    return torch.as_tensor(np.digitize(s, MC_EDGES), dtype=torch.int64,
                           device=X.device)


def classify_ext_model(name, labels, block=None, grad_impl=None,
                       count=None):
    """The evidence fn(kernel, z, X) of a classify_ext leg: "ep" (``count``
    sweeps, EP_SWEEPS by default, ``grad_impl`` "stationary" by default) or
    "multi" (``count`` Newton steps, MC_STEPS by default, dense or streamed
    by ``block``, "ift" by default), at jitter 1e-6, on ``labels`` (EP's
    cast to X's dtype)."""
    if name == "ep":
        return lambda k, z, X: ep_log_evidence(
            k, z, X, labels.to(X.dtype), n_sweeps=count or EP_SWEEPS,
            jitter=JITTER, grad_impl=grad_impl or "stationary")
    steps = count or MC_STEPS
    if block is None:
        return lambda k, z, X: multiclass_log_evidence(
            k, z, X, labels, MC_CLASSES, newton_iters=steps, jitter=JITTER,
            grad_impl=grad_impl or "ift")
    return lambda k, z, X: stream_multiclass_log_evidence(
        k, z, X, labels, MC_CLASSES, block_size=block, newton_iters=steps,
        jitter=JITTER, grad_impl=grad_impl or "ift")


def classify_ext_value_and_grad(name, labels, X, Z, block=None,
                                grad_impl=None, count=None):
    """A leg's evidence at bench's SE-iso hypers and its gradient groups
    (log_ell, log_sf2, z), in X's dtype on X's device."""
    k = SeIso(LOG_ELL, LOG_SF2, device=X.device, dtype=X.dtype)
    z = leaf(Z, X.dtype, X.device)
    ev = classify_ext_model(name, labels, block, grad_impl, count)(k, z, X)
    return grads_of(ev, k, z)


def ep_bound(n, d, m, sweeps) -> dict:
    """EP's value and gradient, dense: per sweep the site Gram V'QV
    (2 n m^2) and the marginals' triangular solve V R^-1 (n m^2); the
    evidence's Gram and solve and their backward (9 n m^2), V = Knm U^-1
    and its two backward products (6 n m^2), Knm and its pullback
    (~4 n m d); X, y and z read, the evidence and the gradients written."""
    flops = (3 * sweeps + 15) * n * m * m + 4.0 * n * m * d
    return bound(flops, 4.0 * (n * (d + 1) + 2 * m * d + 2))


def multi_bound(n, d, m, steps, n_c, block=None) -> dict:
    """The softmax Laplace's value and gradient: per Newton step the C
    per-class and C(C+1)/2 coupling Grams (2 n m^2 each); as many again at
    the mode for the evidence, twice that for their backward and once for
    the IFT backward's factors; V and its backward (6 n m^2), Knm and its
    pullback (~4 n m d).  Streamed (``block``), each of a step's six sweeps
    and the ~20 sweeps of the epilogue and the IFT backward recompute the
    tile V (2 n m^2 + 2 n m d).  X, the labels and z read, the evidence and
    the gradients written."""
    grams = n_c + n_c * (n_c + 1) // 2
    flops = 2.0 * grams * (steps + 4) * n * m * m + 6.0 * n * m * m \
        + 4.0 * n * m * d
    if block is not None:
        flops += (6 * steps + 20) * (2.0 * n * m * m + 2.0 * n * m * d)
    return bound(flops, 4.0 * (n * (d + 1) + 2 * m * d + 2))


def classify_ext_vs_twin(tag, name, labels, X32, Z, block, dev, card,
                         b) -> tuple:
    """``vs_twin`` of a classify_ext leg, CLASSIFY_EXT_F32_NOT_HELD its
    loose groups, timed (median of EXT_REPS) beside its bound ``b``."""
    return vs_twin("classify_ext", tag,
                   lambda lab, X, Z: classify_ext_value_and_grad(
                       name, lab, X, Z, block), GROUPS, labels, X32, Z, dev,
                   card, CLASSIFY_EXT_F32_NOT_HELD, EXT_REPS, b)


def ep_trace(X32, labels, Z, card) -> None:
    """The rms site-precision change of each of bench's EP_SWEEPS sweeps,
    f32 at 1M rows (convergence shows as deltas that shrink)."""
    k = SeIso(LOG_ELL, LOG_SF2, device=X32.device, dtype=X32.dtype)
    with torch.no_grad():
        _, v, d = _fitc_prior(k, torch.as_tensor(Z, device=X32.device), X32,
                              JITTER)
        y = labels.to(X32.dtype)
        *_, deltas = ep_sweeps(v, d, y, torch.ones_like(y),
                               n_sweeps=EP_SWEEPS, trace=True)
    deltas = deltas.cpu().tolist()
    log(f"classify_ext ep sweeps f32 at {X32.shape[0]} rows, rms site "
        f"precision change by sweep: "
        f"{', '.join(f'{x:.2e}' for x in deltas)} ({card})")
    check("classify_ext ep trace", all(math.isfinite(x) for x in deltas)
          and deltas[-1] < deltas[0], f"deltas {deltas}")


def twin_errors(tag, what, ev, grads, twin, card) -> None:
    errs = ", ".join(f"{g_name} {rel_norm(g, w):.2e}" for g_name, g, w in
                     zip(GROUPS, grads, twin[1]))
    log(f"classify_ext {tag}, {what}: evidence rel "
        f"{(ev - twin[0]) / abs(twin[0]):+.2e}; grads {errs} ({card})")


def multi_ablation(labels, X32, Z, twin, card) -> None:
    """For information, not held: the dense multi-class leg in f32
    throughout, the JAX package's choice (``ift.MODE_DTYPE`` f32: the
    Newton steps, the IFT solve and the epilogue), against its f64 twin."""
    kept = ift.MODE_DTYPE
    ift.MODE_DTYPE = torch.float32
    try:
        ev, grads = classify_ext_value_and_grad("multi", labels, X32, Z)
    finally:
        ift.MODE_DTYPE = kept
    twin_errors("ablation multi dense", "all in f32", ev, grads, twin, card)


def ep_f64_on_f32(labels, X32, Z, twin, card) -> None:
    """For information, not held: bench's EP leg with its sweeps and its
    evidence in f64 on the f32 V and d (``classify.prior_up``; the
    library runs them in the rows' dtype, as JAX does) against its f64
    twin."""
    k = SeIso(LOG_ELL, LOG_SF2, device=X32.device, dtype=X32.dtype)
    z = leaf(Z, X32.dtype, X32.device)
    _, v, d = prior_up(k, z, X32, JITTER)
    y = labels.double()
    mask = torch.ones_like(y)
    with torch.no_grad():
        ttau, tnu = ep_sweeps(v, d, y, mask, n_sweeps=EP_SWEEPS)
    ev, grads = grads_of(ep_log_evidence_from_sites(v, d, y, mask, ttau,
                                                    tnu).float(), k, z)
    twin_errors("ep dense", "sweeps and evidence in f64 on the f32 V", ev,
                grads, twin, card)


def classify_ext_routes(X32, Z, labels, card) -> None:
    """The gradient routes in f64 at LAPLACE_ROWS rows: EP "stationary" against
    "unroll"; the dense multi-class "ift" against "unroll"; the streaming
    multi-class (block 8,192) against the dense.  They agree at a fixed
    point, so they are held with the sites and the mode converged
    (EP_ROUTE_SWEEPS sweeps, MC_ROUTE_STEPS Newton steps): the evidence
    within 1e-9 and each gradient group within 1e-6 (JAX's
    tests/test_ift.py bound); at bench's EP_SWEEPS and MC_STEPS the first
    two are printed for information (not held)."""
    X = X32[:LAPLACE_ROWS].double()
    cases = (("ep stationary vs unroll", "ep", labels["ep"], None,
              "stationary", None, "unroll", (EP_SWEEPS, EP_ROUTE_SWEEPS)),
             ("multi ift vs unroll", "multi", labels["multi"], None, "ift",
              None, "unroll", (MC_STEPS, MC_ROUTE_STEPS)),
             ("multi stream vs dense", "multi", labels["multi"], BLOCK,
              "ift", None, "ift", (MC_ROUTE_STEPS,)))
    for tag, name, lab, block_a, gi_a, block_b, gi_b, counts in cases:
        lab = lab[:LAPLACE_ROWS]
        for count in counts:
            held = count == counts[-1]
            t0 = time.perf_counter()
            a = classify_ext_value_and_grad(name, lab, X, Z, block_a, gi_a,
                                            count)
            t1 = time.perf_counter()
            b = classify_ext_value_and_grad(name, lab, X, Z, block_b, gi_b,
                                            count)
            t2 = time.perf_counter()
            rel = abs(a[0] - b[0]) / abs(b[0])
            if held:
                check(f"classify_ext {tag} evidence", rel <= 1e-9,
                      f"rel {rel:.3e}")
            errs = []
            for g_name, g, w in zip(GROUPS, a[1], b[1]):
                err = rel_norm(g, w)
                if held:
                    check(f"classify_ext {tag} {g_name}", err <= 1e-6,
                          f"rel {err:.3e}")
                errs.append(f"{g_name} {err:.2e}")
            log(f"classify_ext {tag} (f64, {LAPLACE_ROWS} rows, {count} "
                f"{'sweeps' if name == 'ep' else 'steps'}"
                f"{'' if held else ', not held'}): evidence {rel:.2e}; "
                f"{', '.join(errs)}; {t1 - t0:.2f} s and {t2 - t1:.2f} s "
                f"({card})")


def classify_ext_fits(dev, card, X32, Z, labels) -> None:
    """fit_classify_ep (on the labels sign(yf) of the fit phase's targets:
    bench's EP labels are noise) and fit_classify_multi dense and streaming
    (block 8,192; on the labels digitize(yf, MC_FIT_EDGES): bench's
    multi-class labels are separable, which sends sf2 up, iteration after
    iteration), bench's MC_STEPS Newton steps, EXT_FIT_ITERS iterations in
    f32 on the first LAPLACE_ROWS rows from bench's hypers (z = Z), the
    line search's curvature window 0.9: finite, and the mean NLL falls."""
    X = X32[:LAPLACE_ROWS]
    yf = bench_targets(dev, X32)[:LAPLACE_ROWS]
    yc = torch.where(yf > 0, 1.0, -1.0)
    lab = torch.as_tensor(np.digitize(yf.cpu().numpy(), MC_FIT_EDGES),
                          dtype=torch.int64, device=dev)
    z0 = torch.as_tensor(Z, device=dev)
    for tag, block in (("ep", None), ("multi", None), ("multi stream", BLOCK)):
        k = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float32)
        pack = make_pack(k, z0, 1.0, learn_sigma2=False)
        # tol: the curvature window of the Wolfe line search, L-BFGS's
        # usual 0.9 (the default 0.1 took ~27 evaluations an iteration on
        # the multi-class objective: 133 for 5 iterations)
        kw = dict(max_iter=EXT_FIT_ITERS, jitter=JITTER, epsabs=1e-6,
                  tol=0.9)
        t0 = time.perf_counter()
        if tag == "ep":
            st = fit_classify_ep(X, yc, pack, n_sweeps=EP_SWEEPS, **kw)[-1]
            fn = classify_ext_model("ep", yc)
        else:
            st = fit_classify_multi(X, lab, pack, MC_CLASSES,
                                    newton_iters=MC_STEPS, block_size=block,
                                    **kw)[-1]
            fn = classify_ext_model("multi", lab, block)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with torch.no_grad():
            f0 = -float(fn(k, z0, X)) / LAPLACE_ROWS
        f1 = float(st.f)
        log(f"classify_ext fit {tag}: {int(st.n_iter)} iterations, "
            f"{int(st.n_evals)} evaluations in {secs:.2f} s "
            f"({1e3 * secs / max(int(st.n_evals), 1):.1f} ms each); mean "
            f"NLL {f0:.6f} -> {f1:.6f} ({card})")
        check(f"classify_ext fit {tag}", math.isfinite(f1) and f1 < f0,
              f"mean NLL {f0} -> {f1}")


def classify_ext_predict(dev, card, X32, Z, labels) -> None:
    """Trained on the first LAPLACE_ROWS rows, served at the next ones, f32:
    ep_predict against ``ep_posterior_state`` through the standard
    predictors (the latent means within 1e-5 and the variances within 1e-4,
    relative: section 2's serving bounds; probabilities in (0, 1) within
    1e-4: Phi's slope and the variances' bound); the dense multi-class state
    (``multiclass_posterior_state``) against the streamed one
    (``stream_multiclass_state``, block 8,192): mu, Sigma and the Monte
    Carlo probabilities (1,024 draws of one generator seed) within 1e-5,
    each row's probabilities summing to 1.  Then the dense state at the 1M
    rows, timed once with its peak memory."""
    X = X32[:LAPLACE_ROWS]
    Xs = X32[LAPLACE_ROWS:2 * LAPLACE_ROWS]
    k = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float32)
    z = torch.as_tensor(Z, device=dev)
    yc = labels["ep"][:LAPLACE_ROWS]
    with torch.no_grad():
        t0 = time.perf_counter()
        p, mu, var = ep_predict(k, z, X, yc, Xs, n_sweeps=EP_SWEEPS,
                                jitter=JITTER)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        inducing, coeffs, rn = ep_posterior_state(
            k, z, X, yc, n_sweeps=EP_SWEEPS, jitter=JITTER)
        mu_s = predict_means(k, MeanPredictor(z=inducing.z, coeffs=coeffs),
                             Xs)
        var_s = predict_variances(k, CoVariancePredictor(
            z=inducing.z, chol_km=inducing.chol_km,
            r_mat=rn @ inducing.chol_km), Xs, 0.0, predictive=False)
        p_s = torch.special.ndtr(mu_s / torch.sqrt(1.0 + var_s.clamp(min=0)))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    diff = float(torch.max(torch.abs(p - p_s)))
    inside = bool(((p > 0) & (p < 1)).all())
    kept = ift.MODE_DTYPE
    ift.MODE_DTYPE = torch.float32  # the JAX package's dtype, for information
    try:
        with torch.no_grad():
            _, mu_32, var_32 = ep_predict(k, z, X, yc, Xs, n_sweeps=EP_SWEEPS,
                                          jitter=JITTER)
    finally:
        ift.MODE_DTYPE = kept
    log(f"classify_ext ep predict all in f32, for information: latent mean "
        f"{rel_norm(mu_32, mu):.2e} and variance {rel_norm(var_32, var):.2e}"
        f" from the library's (2-norm) ({card})")
    log(f"classify_ext ep predict: {Xs.shape[0]} points, ep_predict "
        f"{1e3 * (t1 - t0):.1f} ms, the state route {1e3 * (t2 - t1):.1f} "
        f"ms; probabilities in (0, 1) {inside}, max |difference| "
        f"{diff:.2e}, latent mean {rel_norm(mu_s, mu):.2e} and variance "
        f"{rel_norm(var_s, var):.2e} relative (2-norm) ({card})")
    e_mu, e_var = rel_norm(mu_s, mu), rel_norm(var_s, var)
    check("classify_ext ep predict", inside and diff <= 1e-4
          and e_mu <= 1e-5 and e_var <= 1e-4,
          f"in (0, 1) {inside}, diff {diff:.3e}, mean {e_mu:.3e}, variance "
          f"{e_var:.3e}")

    lab = labels["multi"][:LAPLACE_ROWS]
    out = {}
    with torch.no_grad():
        for route in ("dense", "stream"):
            t0 = time.perf_counter()
            if route == "dense":
                state = multiclass_posterior_state(
                    k, z, X, lab, MC_CLASSES, newton_iters=MC_STEPS,
                    jitter=JITTER)
            else:
                state = stream_multiclass_state(
                    k, z, X, lab, MC_CLASSES, block_size=BLOCK,
                    newton_iters=MC_STEPS, jitter=JITTER)
            pred = multiclass_predict_from_state(
                k, state[0].z, *state[1:], Xs,
                generator=torch.Generator(dev).manual_seed(0))
            torch.cuda.synchronize()
            out[route] = (state, pred, time.perf_counter() - t0)
    (sd, pd, td), (ss, ps, ts) = out["dense"], out["stream"]
    state_errs = ", ".join(f"{n} {rel_norm(a, b):.2e}" for n, a, b in zip(
        ("coeffs", "a_tilde", "b_tilde"), ss[1:], sd[1:]))
    errs = {n: float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))
            for n, a, b in zip(("probs", "mu", "sigma"), ps, pd)}
    sums = float(torch.max(torch.abs(pd[0].sum(dim=1) - 1.0)))
    log(f"classify_ext multi predict: {Xs.shape[0]} points, dense state and "
        f"serving {td:.2f} s, streaming {ts:.2f} s; streaming vs dense "
        f"state {state_errs}; served "
        f"{', '.join(f'{n} {e:.2e}' for n, e in errs.items())}; max |sum of "
        f"probabilities - 1| {sums:.2e} ({card})")
    check("classify_ext multi predict", all(e <= 1e-5 for e in errs.values())
          and sums <= 1e-5, f"{errs}, sums {sums:.3e}")

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        state = multiclass_posterior_state(
            k, z, X32, labels["multi"], MC_CLASSES, newton_iters=MC_STEPS,
            jitter=JITTER)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    finite = all(bool(torch.isfinite(t).all()) for t in state[1:])
    log(f"time classify_ext multi posterior state f32 at {X32.shape[0]} "
        f"rows: {secs:.2f} s (once), peak memory {peak / 2**30:.2f} GiB "
        f"above the data, finite {finite} ({card})")
    check("classify_ext multi state 1M", finite, "a state entry not finite")


def classify_ext_phase(dev, card: str, data) -> None:
    """bench.py's EP leg (dense at 1M, f32 against the f64 twin, the trace of
    its sweeps) and multi-class leg (dense at 1M, streaming at LAPLACE_ROWS),
    each timed beside its bound; the gradient routes in f64; three fits;
    the EP and multi-class predictions.  No kernel launches on any of
    them."""
    X32, y32, Z = data
    t0 = time.perf_counter()
    labels = {"ep": torch.sign(y32) + (y32 == 0).to(torch.float32),
              "multi": multi_labels(X32)}
    counts = torch.bincount(labels["multi"], minlength=MC_CLASSES).tolist()
    b_ep = ep_bound(N, D, M, EP_SWEEPS)
    b_mc = multi_bound(N, D, M, MC_STEPS, MC_CLASSES)
    b_ms = multi_bound(LAPLACE_ROWS, D, M, MC_STEPS, MC_CLASSES, BLOCK)
    log(f"classify_ext bounds: bench's EP leg {b_ep['bound_ms']:.3f} ms "
        f"({b_ep['bound_by']}), multi-class dense {b_mc['bound_ms']:.3f} ms "
        f"({b_mc['bound_by']}), streaming at {LAPLACE_ROWS} rows "
        f"{b_ms['bound_ms']:.3f} ms ({b_ms['bound_by']}); class counts "
        f"{counts}")

    ep_trace(X32, labels["ep"], Z, card)
    twin = classify_ext_vs_twin("ep dense", "ep", labels["ep"], X32, Z, None,
                                dev, card, b_ep)
    ep_f64_on_f32(labels["ep"], X32, Z, twin, card)
    twin = classify_ext_vs_twin("multi dense", "multi", labels["multi"], X32,
                                Z, None, dev, card, b_mc)
    multi_ablation(labels["multi"], X32, Z, twin, card)
    classify_ext_vs_twin(f"multi stream {LAPLACE_ROWS}", "multi",
                         labels["multi"][:LAPLACE_ROWS], X32[:LAPLACE_ROWS], Z,
                         BLOCK, dev, card, b_ms)
    _, launches = counted("classify_ext routes, fits and predictions",
                          lambda: (classify_ext_routes(X32, Z, labels, card),
                                   classify_ext_fits(dev, card, X32, Z,
                                                     labels),
                                   classify_ext_predict(dev, card, X32, Z,
                                                        labels)), ())
    check("classify_ext launches", not any(launches.values()),
          f"{launches}, want all 0")
    log(f"classify_ext phase: {time.perf_counter() - t0:.1f} s ({card})")


# -- iterative: the iterative exact GP (models/iterative.py) at n = 100,000
ITER_ROWS, ITER_ANCHORS, ITER_TEST = 100_000, 1_024, 256
ITER_LOG_ELL, ITER_LOG_SF2, ITER_SIGMA2 = 1.0, 0.0, 0.1
ITER_COLS = (1, 9)  # the matvec's columns: y alone, and y with 8 probes
ITER_PROBES = 8
# The gradient step's peak, GiB above the data: reverse mode that kept every
# (block, n) tile would stack 13 tiles of 3.3 GB (42.6 GB) per saved tensor.
ITER_PEAK_GIB = 26.0
ITER_F64_TOL, ITER_F64_SEEDS = 1e-8, 4  # the f64 leg at EXACT_ROWS rows
ITER_F64_TEST = 1_000


def iter_data(dev, X32):
    """probes/r5_iterative_tpu.py's problem on bench's rows: X[:ITER_ROWS]
    and y = sin(sum x) + 0.1 N(0, 1), the noise from default_rng(1)."""
    X = X32[:ITER_ROWS]
    noise = np.random.default_rng(1).standard_normal(ITER_ROWS)
    y = torch.sin(X.sum(dim=1)) + 0.1 * torch.as_tensor(
        noise, dtype=torch.float32, device=dev)
    return X, y


def iter_kernel(dev, dtype):
    return SeIso(ITER_LOG_ELL, ITER_LOG_SF2, device=dev, dtype=dtype)


def matvec_bound(n, d, r) -> dict:
    """(K + sigma2 I) V over n rows: per entry of K the cross product (d
    FMAs), the squared-distance assembly, scale and exp (4 operations) and
    the product with V's r columns (r FMAs); X and V read once, the result
    written once."""
    return bound(n * n * (2.0 * d + 4.0 + 2.0 * r), 4.0 * n * (d + 2 * r))


def peak_run(dev, fn):
    """(fn's result, seconds, peak GiB above what was allocated before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, (torch.cuda.max_memory_allocated(dev) - base) / 2**30


def clocked(fn):
    """(fn's result, seconds, the SM clock and power while it ran)."""
    sampler = clock_log()
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.time()
    finally:
        samples = read_clock_log(sampler)
    return out, t1 - t0, clock_window(samples, t0, t1)


def iter_matvec_leg(dev, card, X, k32, k64) -> list:
    """``kernel_matvec`` alone at each of ITER_COLS columns: f32 against its
    f64 twin on the card (1e-5 relative), the median of 3 times beside the
    bound."""
    V = torch.randn((ITER_ROWS, max(ITER_COLS)), device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    rows = []
    with torch.no_grad():
        for r in ITER_COLS:
            def mv(r=r):
                return iterative.kernel_matvec(k32, X, V[:, :r], ITER_SIGMA2,
                                               block_size=BLOCK)
            err = rel_norm(mv(), iterative.kernel_matvec(
                k64, X.double(), V[:, :r].double(), ITER_SIGMA2,
                block_size=BLOCK))
            sampler = clock_log()
            try:
                t0 = time.time()
                ms = median_ms(mv, reps=3)
                t1 = time.time()
            finally:
                samples = read_clock_log(sampler)
            b = matvec_bound(ITER_ROWS, D, r)
            log(f"iterative kernel_matvec n={ITER_ROWS} r={r} block={BLOCK} "
                f"f32: {ms:.3f} ms (median of 3), rel {err:.2e} from the f64"
                f" twin; bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
                f"{b['bound_ms'] / ms:.1%} of it; "
                f"{clock_window(samples, t0, t1)} ({card})")
            check(f"iterative kernel_matvec r={r}", err <= 1e-5,
                  f"rel {err:.3e} from the f64 twin")
            rows.append((r, ms, b))
    return rows


def iter_f64_leg(dev, card, X32, y32) -> None:
    """EXACT_ROWS rows in f64: CG's alpha, means and variances against the
    dense ``models/exact.py`` (10 x the CG tolerance, relative 2-norm), and
    ``evidence_grads_iter`` averaged over ITER_F64_SEEDS generator seeds
    within 10 % of the exact autograd gradient (JAX's criterion)."""
    n, f64 = EXACT_ROWS, torch.float64
    X, y = X32[:n].double(), y32[:n].double()
    Xs = X32[ITER_ROWS:ITER_ROWS + ITER_F64_TEST].double()
    k = iter_kernel(dev, f64)
    gen = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        t0 = time.perf_counter()
        tr = iterative.iter_trained(k, X, y, ITER_SIGMA2,
                                    n_inducing=ITER_ANCHORS, generator=gen,
                                    tol=ITER_F64_TOL, max_iter=1_000,
                                    block_size=BLOCK)
        pre = iterative.nystrom_precond(k, X, ITER_SIGMA2, X[:ITER_ANCHORS])
        mu = iterative.predict_means_iter(k, tr, Xs, block_size=BLOCK)
        var, info = iterative.predict_variances_iter(
            k, tr, X, Xs, precond=pre, tol=ITER_F64_TOL, max_iter=1_000,
            block_size=BLOCK)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense = exact_trained(calc_exact(k, X, ITER_SIGMA2), y)
        errs = {"alpha": rel_norm(tr.alpha, dense.alpha),
                "means": rel_norm(mu, predict_means_exact(k, dense, Xs)),
                "variances": rel_norm(var, predict_variances_exact(k, dense,
                                                                  Xs))}
    log(f"iterative f64 at {n} rows, tol {ITER_F64_TOL:g}: alpha "
        f"{tr.iters} iterations (relres {float(tr.relres):.2e}), "
        f"{ITER_F64_TEST} variances {info['iters']} iterations; "
        f"{t1 - t0:.2f} s; rel errors against the dense exact GP "
        + ", ".join(f"{k_} {v:.2e}" for k_, v in errs.items())
        + f" (bound {10 * ITER_F64_TOL:g}) ({card})")
    check("iterative f64 vs exact", all(v <= 10 * ITER_F64_TOL
                                        for v in errs.values()), f"{errs}")

    s2 = torch.tensor(ITER_SIGMA2, dtype=f64, device=dev,
                      requires_grad=True)
    want = torch.autograd.grad(-log_evidence_exact(k, X, y, s2),
                               (k.log_ell, k.log_sf2, s2))
    acc = [0.0, 0.0, 0.0]
    t0 = time.perf_counter()
    for seed in range(ITER_F64_SEEDS):
        (g, gs), _ = iterative.evidence_grads_iter(
            k, X, y, ITER_SIGMA2, torch.Generator(dev).manual_seed(100 + seed),
            n_probes=ITER_PROBES, n_inducing=ITER_ANCHORS, tol=1e-6,
            max_iter=1_000, block_size=BLOCK)
        for j, v in enumerate((g["log_ell"], g["log_sf2"], gs)):
            acc[j] += float(v) / ITER_F64_SEEDS
    secs = time.perf_counter() - t0
    rel = [abs(a - float(w)) / abs(float(w)) for a, w in zip(acc, want)]
    log(f"iterative f64 evidence_grads_iter mean of {ITER_F64_SEEDS} seeds "
        f"(log_ell, log_sf2, sigma2) {[f'{a:.6g}' for a in acc]} against "
        f"the exact gradient {[f'{float(w):.6g}' for w in want]}: rel "
        f"{[f'{r:.2%}' for r in rel]} (bound 10 %); {secs:.2f} s ({card})")
    check("iterative f64 gradient", all(r <= 0.1 for r in rel), f"{rel}")


def iterative_phase(dev, card: str, data) -> None:
    """probes/r5_iterative_tpu.py's legs on bench's rows (f32, SE-iso at
    log_ell 1, sigma2 0.1, ITER_ANCHORS anchors, block 8,192): the matvec
    against its f64 twin, the alpha solve, the variances, the SGD step and
    its peak memory; then the f64 checks at EXACT_ROWS rows.  No kernel
    launches: the iterative path runs k_cross tiles and cuBLAS products."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    X, y = iter_data(dev, data[0])
    k32 = iter_kernel(dev, torch.float32)

    def legs():
        iter_matvec_leg(dev, card, X, k32, iter_kernel(dev, torch.float64))
        anchors = X[torch.randperm(ITER_ROWS, device=dev, generator=torch
                                   .Generator(dev).manual_seed(0))
                    [:ITER_ANCHORS]]
        tr, secs, peak = peak_run(dev, lambda: iterative.iter_trained(
            k32, X, y, ITER_SIGMA2, X_sub=anchors, tol=1e-3, max_iter=400,
            block_size=BLOCK))
        relres = float(tr.relres)
        log(f"iterative alpha n={ITER_ROWS} m={ITER_ANCHORS} block={BLOCK} "
            f"tol 1e-3 f32: {1e3 * secs:.1f} ms, {tr.iters} iterations, "
            f"true relres {relres:.3e}, peak {peak:.2f} GiB above the data "
            f"({card})")
        check("iterative alpha", relres <= 1e-3
              and bool(torch.isfinite(tr.alpha).all()),
              f"true relres {relres:.3e}")

        Xs = data[0][ITER_ROWS:ITER_ROWS + ITER_TEST]
        with torch.no_grad():
            pre = iterative.nystrom_precond(k32, X, ITER_SIGMA2, anchors)
        (var, info), secs, clock = clocked(
            lambda: iterative.predict_variances_iter(
                k32, tr, X, Xs, precond=pre, tol=1e-4, max_iter=400,
                block_size=BLOCK))
        vrel = float(info["relres"].max())
        log(f"iterative variances {ITER_TEST} points tol 1e-4 f32 (the "
            f"anchors' preconditioner): {1e3 * secs:.1f} ms, {info['iters']}"
            f" iterations, true relres {vrel:.2e}, range "
            f"[{float(var.min()):.4f}, {float(var.max()):.4f}]; {clock} "
            f"({card})")
        check("iterative variances", bool(torch.isfinite(var).all())
              and bool((var >= ITER_SIGMA2).all()), "not finite or below s2")

        def step():
            (g, gs), info = iterative.evidence_grads_iter(
                k32, X, y, ITER_SIGMA2, torch.Generator(dev).manual_seed(2),
                n_probes=ITER_PROBES, n_inducing=ITER_ANCHORS, tol=1e-3,
                max_iter=400, block_size=BLOCK)
            kernel, s2 = iterative.sgd_update(
                k32, torch.tensor(ITER_SIGMA2, device=dev), g, gs, 0,
                ITER_ROWS)
            return g, gs, info, kernel, s2

        (g, gs, info, kernel, s2), secs, peak = peak_run(dev, step)
        finite = all(bool(torch.isfinite(v)) for v in (*g.values(), gs, s2))
        log(f"iterative SGD step n={ITER_ROWS} {ITER_PROBES} probes tol 1e-3 "
            f"f32: {secs:.3f} s, {info['iters']} iterations (relres "
            f"{float(info['relres'].max()):.2e}); gradient (log_ell, "
            f"log_sf2, sigma2) ({float(g['log_ell']):.4g}, "
            f"{float(g['log_sf2']):.4g}, {float(gs):.4g}) -> log_ell "
            f"{float(kernel.log_ell):.5f}, sigma2 {float(s2):.5f}; peak "
            f"{peak:.2f} GiB above the data (limit {ITER_PEAK_GIB} GiB) "
            f"({card})")
        check("iterative SGD step", finite and peak <= ITER_PEAK_GIB,
              f"finite {finite}, peak {peak:.2f} GiB")
        iter_f64_leg(dev, card, *data[:2])

    _, launches = counted("iterative", legs, ())
    check("iterative launches", not any(launches.values()),
          f"{launches}, want all 0")
    torch.cuda.empty_cache()
    log(f"iterative phase: {time.perf_counter() - t_phase:.1f} s ({card})")


# -- hmc: bench.py's HMC leg (bench.py:804-852) and the streaming route
HMC_ROWS, HMC_TEST = 100_000, 1_000
HMC_KW = dict(n_samples=20, n_warmup=60, n_leapfrog=8, n_chains=1,
              chain_jitter=0.05, init_step=0.02)
HMC_STREAM_KW = dict(HMC_KW, n_samples=10, n_warmup=10)  # 20 transitions
HMC_BAND = (0.65, 0.9)  # .claude/skills/verify/SKILL.md's accept band
HMC_SESSION = "high"  # bench.py:258's session precision: TF32 forces here


def hmc_report(tag, res, secs, card, kw=HMC_KW) -> float:
    leaps = (kw["n_warmup"] + kw["n_samples"]) * kw["n_leapfrog"]
    accept = float(res.accept_rate[0])
    log(f"hmc {tag}: {1e3 * secs / leaps:.3f} ms a leapfrog ({secs:.2f} s "
        f"for {leaps}), min-ESS {float(np.min(res.ess)):.2f} "
        f"({float(np.min(res.ess)) / secs:.3f}/s), accept {accept:.3f}, "
        f"step {float(res.step_size[0]):.4g} ({card})")
    return accept


def hmc_phase(dev, card: str, data) -> None:
    """bench.py's HMC leg as written: 100,000 rows of its draw, SE-iso at
    its hypers, Z (m = 300) fixed, sigma2 0.1 learned, variational, dense;
    8 leapfrog steps, 60 warmup and 20 samples, 1 chain, jitter 0.05, init
    step 0.02, under bench's session precision (``config.matmul_precision =
    "high"``, bench.py:258: TF32 forces on this card) through
    ``sample_posterior`` and the accept energy it ships (f32 at
    "highest"); the same with no accept energy and with it in f64, and with
    full-f32 forces, for information; then 20 transitions on the streaming
    route (block 8,192: #1 and #3 once a force, #1 once more an accept
    energy) and the mixture predictive of their draws at HMC_TEST
    points."""
    t_phase = time.perf_counter()
    X32, y32, Z = data
    X, y = X32[:HMC_ROWS], y32[:HMC_ROWS]
    k, z, _ = bench_model(dev, Z, torch.float32)
    pack = make_pack(k, z, SIGMA2, learn_inducing=False)
    # the accept energy in f64 on the same rows, for the ablation
    k64, z64, _ = bench_model(dev, Z, torch.float64)
    energy64 = make_accept_energy(
        X.double(), y.double(), make_pack(k64, z64, SIGMA2,
                                          learn_inducing=False),
        variational=True)
    forces, _ = make_objective(X, y, pack, variational=True)

    def run(seed, session=HMC_SESSION, f64_energy=False, **kw):
        config.matmul_precision = session
        gen = torch.Generator(dev).manual_seed(seed)
        try:
            if f64_energy:
                return hmc(forces, pack.x0, gen, energy_fn=lambda x: energy64(
                    x.double()).float(), **HMC_KW)
            return sample_posterior(X, y, pack, gen, variational=True,
                                    **{**HMC_KW, **kw})
        finally:
            config.matmul_precision = "highest"

    accepts = {}
    res, first, _ = clocked(lambda: run(5))
    log(f"hmc first call: {first:.2f} s ({card})")
    res, secs, clock = clocked(lambda: run(6))
    accepts["f32 highest (shipped)"] = hmc_report(
        f"bench leg, sample_posterior, {HMC_SESSION} forces", res, secs,
        card)
    log(f"hmc bench leg clock: {clock} ({card})")
    for tag, kw in (("none", {"accept_precision": None}),
                    ("f64 on the f32 data", {"f64_energy": True}),
                    ("f32 highest, highest forces", {"session": "highest"})):
        res_a, secs, _ = clocked(lambda kw=kw: run(6, **kw))
        accepts[tag] = hmc_report(f"accept energy {tag}", res_a, secs, card)
    log("hmc accept-energy ablation: " + ", ".join(
        f"{k_} {v:.3f}" for k_, v in accepts.items()) + f" ({card})")
    shipped = accepts["f32 highest (shipped)"]
    check("hmc accept band", HMC_BAND[0] <= shipped <= HMC_BAND[1],
          f"accept {shipped:.3f} outside {HMC_BAND}")
    check("hmc draws", bool(torch.isfinite(res.samples).all()),
          "nonfinite draws")

    def stream():
        return sample_posterior(X, y, pack, torch.Generator(dev).manual_seed(7),
                                variational=True, block_size=BLOCK,
                                **HMC_STREAM_KW)

    t0 = time.perf_counter()
    res_s, launches = counted("hmc streaming", stream,
                              (FWD_KERNEL, BWD_KERNEL))
    secs = time.perf_counter() - t0
    hmc_report(f"streaming block {BLOCK}", res_s, secs, card, HMC_STREAM_KW)
    transitions = HMC_STREAM_KW["n_warmup"] + HMC_STREAM_KW["n_samples"]
    forces = 1 + transitions * HMC_STREAM_KW["n_leapfrog"]
    energies = 1 + transitions
    log(f"hmc streaming launches: {forces} forces and {energies} accept "
        f"energies; #1 {launches[FWD_KERNEL]} (want {forces + energies}), "
        f"#3 {launches[BWD_KERNEL]} (want {forces}) ({card})")
    check("hmc streaming launches", launches[BWD_KERNEL] == forces
          and launches[FWD_KERNEL] == forces + energies, f"{launches}")

    Xt = X32[HMC_ROWS:HMC_ROWS + HMC_TEST]
    (mean, var), secs, _ = clocked(lambda: predict_hmc_mixture(
        pack, res_s.samples, X, y, Xt, variational=True))
    per_draw = torch.stack([predict_hmc_mixture(
        pack, s[None], X, y, Xt, variational=True)[1]
        for s in res_s.flat])
    floor = per_draw.min(dim=0).values
    ok = bool(torch.isfinite(mean).all() and torch.isfinite(var).all()
              and (var >= floor).all())
    log(f"hmc mixture of {res_s.flat.shape[0]} draws at {HMC_TEST} points: "
        f"{1e3 * secs:.1f} ms; finite, and at least the single draws' "
        f"smallest variance: {ok} (variance {float(var.min()):.5f}.."
        f"{float(var.max()):.5f}) ({card})")
    check("hmc mixture", ok, "nonfinite or below the per-draw minimum")
    log(f"hmc phase: {time.perf_counter() - t_phase:.1f} s ({card})")



# -- cli: the command-line trainer/predictor in subprocesses
CLI_TRAIN, CLI_TEST = 200_000, 100_000  # rows of bench's draw
# the parallel phase: gpr_tpu_torch/parallel/ at bench's full width
PAR_RANKS = 2  # gloo ranks sharing the one card; NCCL where each has one
PAR_FIT_ITERS = 5
PAR_TIMES = 5  # evaluations timed, after a warm-up
PAR_ALLSUM_REPS = 20


def par_model(dev, Z):
    """bench's SE-iso model (log_ell 0.5, sigma2 0.1), f32, packed."""
    return make_pack(*bench_model(dev, Z, torch.float32))


def par_value_and_grad(mesh, pack, X, y, mask):
    """The sharded evidence over this rank's rows and its gradient over the
    packed hypers (spmd.sharded_value_and_grad)."""
    def f(x):
        kernel, z, s2 = pack.unpack(x)
        return sharded_log_evidence(kernel, mesh, z, s2, X, y, mask,
                                    block_size=BLOCK, jitter=JITTER)

    return sharded_value_and_grad(mesh, f, pack.x0)


def single_value_and_grad(pack, X, y):
    """The same on one device: streaming_log_evidence's default route."""
    def f(x):
        kernel, z, s2 = pack.unpack(x)
        return streaming.streaming_log_evidence(
            kernel, z, s2, X, y, block_size=BLOCK, jitter=JITTER)

    return value_and_grad(f)(pack.x0)


def pack_groups(pack, g):
    """The packed gradient's groups: sigma2, log_ell, log_sf2, z."""
    return {"sigma2": g[:1], "log_ell": g[1:2], "log_sf2": g[2:3],
            "z": g[3:]}


def parallel_one_rank(mesh):
    """(a): on a one-rank world, the sharded evidence and its gradient and,
    in the same process, streaming_log_evidence's."""
    X32, y32, Z = bench_data(mesh.device)
    pack = par_model(mesh.device, Z)
    got = par_value_and_grad(mesh, pack, *shard_batch(mesh, X32, y32))
    return mesh.backend, got, single_value_and_grad(pack, X32, y32)


def rank_launches(mesh, fn):
    """fn() with every launch counter of this rank set to 0 just before it;
    (fn's result, each rank's counts of #1 and #3 just after)."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize(mesh.device)
    mine = torch.tensor([[WRAPPERS[FWD_KERNEL].launches,
                          WRAPPERS[BWD_KERNEL].launches]],
                        dtype=torch.float64, device=mesh.device)
    return out, mesh.all_gather(mine).long().tolist()


def rank_median_ms(mesh, fn, reps=PAR_TIMES):
    """Host clock around ``reps`` lock-step calls after a warm-up: (median
    ms, the window's unix start and end)."""
    fn()
    torch.cuda.synchronize(mesh.device)
    t0, times = time.time(), []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(mesh.device)
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times), (t0, time.time())


def parallel_ranks(mesh, serving, anchors):
    """(b)-(f) on each rank of the phase's world; rank 0's results."""
    dev = mesh.device
    X32, y32, Z = bench_data(dev)
    pack = par_model(dev, Z)
    shards = shard_batch(mesh, X32, y32)
    out = {"backend": mesh.backend, "cards": mesh.all_gather(torch.tensor(
        [dev.index], device=dev)).tolist()}
    # (b) the main path: one evaluation, counted in every rank, then timed
    out["vg"], out["launches"] = rank_launches(
        mesh, lambda: par_value_and_grad(mesh, pack, *shards))
    out["ms"], out["window"] = rank_median_ms(
        mesh, lambda: par_value_and_grad(mesh, pack, *shards))
    stats = torch.ones(M * M + M + 4, dtype=torch.float32, device=dev)
    out["allsum_ms"], _ = rank_median_ms(mesh, lambda: [
        mesh.allsum(stats) for _ in range(PAR_ALLSUM_REPS)])
    out["allsum_ms"] /= PAR_ALLSUM_REPS
    yf = bench_targets(dev, X32)
    fit_pack = make_pack(SeIso(LOG_ELL, LOG_SF2, device=dev,
                               dtype=torch.float32),
                         torch.as_tensor(Z, device=dev), 1.0)
    t = time.perf_counter()
    (*_, st), fit_launches = rank_launches(mesh, lambda: fit_sharded(
        mesh, X32, yf, fit_pack, variational=True, block_size=BLOCK,
        max_iter=PAR_FIT_ITERS, epsabs=1e-4))
    secs = time.perf_counter() - t
    xs = mesh.all_gather(st.x[None])
    out["fit"] = (float(st.f), st.n_iter, st.n_evals, secs,
                  bool(torch.all(xs == xs[0])), fit_launches)
    kernel, z, s2 = pack.unpack(pack.x0)
    with torch.no_grad():
        # (c) TSQR
        t = time.perf_counter()
        out["tsqr"] = (float(sharded_log_evidence_tsqr(
            kernel, mesh, z, s2, *shards, jitter=JITTER)),
            time.perf_counter() - t)
        # (d) serving: all of X's rows split over the ranks
        coeffs, chol_km, r_mat, zi = (v.to(dev) for v in serving)
        t = time.perf_counter()
        out["means"] = sharded_predict_means(kernel, mesh, zi, coeffs, X32,
                                             block_size=BLOCK)
        out["variances"] = sharded_predict_variances(
            kernel, mesh, zi, chol_km, r_mat, X32, SIGMA2, block_size=BLOCK)
        torch.cuda.synchronize(dev)
        out["predict_s"] = time.perf_counter() - t
    # (e) the binary Laplace at 1M rows, dense on each rank's rows
    yc = torch.sign(y32) + (y32 == 0).to(torch.float32)
    k = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float32)
    zc = leaf(Z, torch.float32, dev)
    t = time.perf_counter()
    ev = sharded_classify_log_evidence(k, mesh, zc, *shard_batch(
        mesh, X32, yc), newton_iters=LAPLACE_STEPS, jitter=JITTER)
    grads = sharded_grad(mesh, ev, (k.log_ell, k.log_sf2, zc))
    out["classify"] = (ev.item(), grads, time.perf_counter() - t)
    # (f) the iterative alpha solve over the iterative phase's rows
    X, y = iter_data(dev, X32)
    Xl, yl, ml = shard_batch(mesh, X, y)
    t = time.perf_counter()
    alpha, iters, relres = sharded_iter_solve(
        iter_kernel(dev, torch.float32), mesh, Xl, yl, ITER_SIGMA2,
        anchors.to(dev), ml, tol=1e-3, max_iter=400, block_size=BLOCK)
    out["iter"] = (alpha[:ITER_ROWS], iters, float(relres.max()),
                   time.perf_counter() - t)
    out["staged"] = dict(mesh.staged)
    return out


def parallel_phase(dev, card: str, data) -> None:
    """gpr_tpu_torch/parallel/ on the card at bench's full width: (a) a
    one-rank world against the single-device step; then, on PAR_RANKS ranks
    (gloo sharing the card, or NCCL with a card each), (b) the training
    step, its launches counted in the ranks, its time and fit_sharded's
    lock step, (c) TSQR, (d) the sharded predictors, (e) the binary Laplace
    at 1M rows, (f) the ring-matvec CG solve at ITER_ROWS rows; each against
    the single-device path computed here first."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    X32, y32, Z = data
    backend = choose_backend("cuda", PAR_RANKS)
    # (a)
    t = time.perf_counter()
    be1, (v1, g1), (v0, g0) = run_spmd(parallel_one_rank, 1)
    rel_v = abs(float(v1) - float(v0)) / abs(float(v0))
    rel_g = rel_norm(g1, g0)
    log(f"parallel one rank ({be1}): evidence {float(v1):.3f} against "
        f"streaming_log_evidence's {float(v0):.3f} (rel {rel_v:.2e}), "
        f"gradient rel {rel_g:.2e}; {time.perf_counter() - t:.1f} s with the "
        f"rank's start ({card})")
    check("parallel one rank", rel_v <= 1e-6 and rel_g <= 1e-6,
          f"value rel {rel_v:.2e}, gradient rel {rel_g:.2e}")

    # the single-device references on this process's card
    pack = par_model(dev, Z)
    v_ref, g_ref = single_value_and_grad(pack, X32, y32)
    single_ms = median_ms(lambda: single_value_and_grad(pack, X32, y32))
    yf = bench_targets(dev, X32)
    fit_pack = make_pack(SeIso(LOG_ELL, LOG_SF2, device=dev,
                               dtype=torch.float32),
                         torch.as_tensor(Z, device=dev), 1.0)
    t = time.perf_counter()
    *_, st_ref = fit(X32, yf, fit_pack, variational=True,
                     streaming_block_size=BLOCK, max_iter=PAR_FIT_ITERS,
                     epsabs=1e-4)
    fit_secs = time.perf_counter() - t
    kernel, z, s2 = pack.unpack(pack.x0)
    trained = streaming.streaming_trained(kernel, z, s2, X32, y32,
                                          jitter=JITTER, block_size=BLOCK)
    model = trained.model
    serving = (trained.coeffs, model.inducing.chol_km, model.r_mat,
               model.inducing.z)
    means_ref = streaming.predict_means_blocked(
        kernel, model.inducing.z, trained.coeffs, X32, block_size=BLOCK)
    vars_ref = streaming.predict_variances_blocked(
        kernel, model.inducing.z, model.inducing.chol_km, model.r_mat, X32,
        SIGMA2, block_size=BLOCK)
    yc = torch.sign(y32) + (y32 == 0).to(torch.float32)
    c_ref, cg_ref = laplace_value_and_grad("classify", yc, X32, Z)
    X, y = iter_data(dev, X32)
    anchors = X[torch.randperm(ITER_ROWS, device=dev, generator=torch
                               .Generator(dev).manual_seed(0))
                [:ITER_ANCHORS]]
    tr = iterative.iter_trained(iter_kernel(dev, torch.float32), X, y,
                                ITER_SIGMA2, X_sub=anchors, tol=1e-3,
                                max_iter=400, block_size=BLOCK)
    log(f"parallel references on one card: value+grad {single_ms:.2f} ms, "
        f"fit {PAR_FIT_ITERS} iterations {fit_secs:.2f} s, alpha "
        f"{tr.iters} iterations ({card})")
    torch.cuda.empty_cache()

    sampler = clock_log()
    try:
        t = time.perf_counter()
        res = run_spmd(parallel_ranks, PAR_RANKS,
                       tuple(v.cpu() for v in serving), anchors.cpu())
        world_secs = time.perf_counter() - t
    finally:
        samples = read_clock_log(sampler)
    log(f"parallel world: {PAR_RANKS} ranks, backend {res['backend']} "
        f"(chosen {backend}), rank -> card {dict(enumerate(res['cards']))}; "
        f"{world_secs:.1f} s with the ranks' start ({card})")
    check("parallel backend", res["backend"] == backend, res["backend"])

    # (b)
    v, g = res["vg"][0], res["vg"][1].to(dev)
    rel_v = abs(float(v) - float(v_ref)) / abs(float(v_ref))
    errs = {name: rel_norm(gg, w) for (name, gg), w in zip(
        pack_groups(pack, g).items(), pack_groups(pack, g_ref).values())}
    log(f"parallel step P={PAR_RANKS}: evidence {float(v):.3f} against one "
        f"rank's {float(v_ref):.3f} (rel {rel_v:.2e}); grad rel "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()) + f" ({card})")
    check("parallel step", rel_v <= 2e-5 and max(errs.values()) <= 1e-3,
          f"value rel {rel_v:.2e}, grads {errs}")
    launches = res["launches"]
    log(f"parallel launches per rank (#1, #3) in one evaluation: {launches}")
    check("parallel launches", all(c == [1, 1] for c in launches),
          f"{launches}")
    t0, t1 = res["window"]
    log(f"time parallel value+grad P={PAR_RANKS} ({res['backend']}): "
        f"{res['ms']:.2f} ms per evaluation (one rank on the card: "
        f"{single_ms:.2f} ms); allsum of {M * M + M + 4} f32 "
        f"({4e-6 * (M * M + M + 4):.2f} MB) {res['allsum_ms']:.3f} ms; "
        f"{clock_window(samples, t0, t1)} ({card})")
    f, n_iter, n_evals, secs, equal, fit_launches = res["fit"]
    log(f"parallel fit_sharded P={PAR_RANKS}: {n_iter} iterations, "
        f"{n_evals} evaluations, mean NLL {f:.6f} (fit on one card: "
        f"{float(st_ref.f):.6f}, {st_ref.n_iter} iterations, "
        f"{st_ref.n_evals} evaluations), x bit-equal on the ranks: {equal}; "
        f"{secs:.2f} s = {1e3 * secs / n_evals:.1f} ms per evaluation "
        f"(one card: {1e3 * fit_secs / st_ref.n_evals:.1f}); launches "
        f"(#1, #3) per rank {fit_launches} ({card})")
    check("parallel fit", equal and math.isfinite(f)
          and all(c == [n_evals, n_evals] for c in fit_launches),
          f"x equal {equal}, f {f}, launches {fit_launches}")
    # (c)
    v_tsqr, secs = res["tsqr"]
    rel = abs(v_tsqr - float(v)) / abs(float(v))
    log(f"parallel tsqr P={PAR_RANKS}: evidence {v_tsqr:.3f} against the "
        f"Gram path's {float(v):.3f} (rel {rel:.2e}; truth {TRUTH}), "
        f"{secs:.2f} s ({card})")
    check("parallel tsqr", rel <= 2e-5, f"rel {rel:.2e}")
    # (d)
    e_means = rel_norm(res["means"].to(dev), means_ref)
    e_vars = rel_norm(res["variances"].to(dev), vars_ref)
    log(f"parallel predict P={PAR_RANKS} at {N} points: means rel "
        f"{e_means:.2e}, variances rel {e_vars:.2e} against one card's, "
        f"{res['predict_s']:.3f} s ({card})")
    check("parallel predict", e_means <= 1e-5 and e_vars <= 1e-5,
          f"means {e_means:.2e}, variances {e_vars:.2e}")
    # (e)
    c_v, c_g, secs = res["classify"]
    rel_v = abs(c_v - c_ref) / abs(c_ref)
    errs = {name: rel_norm(gg.to(dev), w) for name, gg, w in zip(
        ("log_ell", "log_sf2", "z"), c_g, cg_ref)}
    log(f"parallel classify P={PAR_RANKS} at {N} rows: evidence {c_v:.3f} "
        f"against one card's {c_ref:.3f} (rel {rel_v:.2e}); grad rel "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f"; {secs:.2f} s ({card})")
    check("parallel classify", rel_v <= 2e-5 and max(errs.values()) <= 1e-3,
          f"value rel {rel_v:.2e}, grads {errs}")
    # (f)
    alpha, iters, relres, secs = res["iter"]
    e_alpha = rel_norm(alpha.to(dev), tr.alpha)
    staged = res["staged"]
    log(f"parallel iter_solve P={PAR_RANKS} at {ITER_ROWS} rows tol 1e-3: "
        f"{iters} iterations (one card: {tr.iters}), true relres "
        f"{relres:.2e}, alpha rel {e_alpha:.2e} from one card's, "
        f"{secs:.2f} s; collectives staged through the host: "
        f"{staged or 'none'} ({card})")
    check("parallel iter_solve", relres <= 1e-3 and e_alpha <= 1e-2,
          f"relres {relres:.2e}, alpha rel {e_alpha:.2e}")
    log(f"parallel phase: {time.perf_counter() - t_phase:.2f} s ({card})")


MESH2D_SHAPE = (2, 2)
MESH2D_RANKS = MESH2D_SHAPE[0] * MESH2D_SHAPE[1]  # gloo ranks on the card
MESH2D_MODES = {  # f32, bench's full width; inducing: whitened by default
    "replicated": {},
    "epilogue": {"epilogue": "distributed"},
    "inducing": {"inducing": "distributed"},
}
MESH2D_F64_MODES = {  # the raw-Gram modes, f64
    "replicated": {},
    "epilogue": {"epilogue": "distributed"},
    "inducing-raw": {"inducing": "distributed", "factorization": "raw"},
    "inducing-whitened": {"inducing": "distributed",
                          "factorization": "whitened"},
}
MESH2D_F64_ROWS = 100_000
MESH2D_TIMES = 2  # evaluations timed a mode, after a warm-up
# what f32 cannot resolve at 1M rows (measured on the H100 at bench's
# width), held in f64 by (b) and (d): the fully distributed mode forms
# Km^-1 and rowsq(V) = rowdot(Knm, Knm Km^-1) in f32 (its z gradient
# 3.3e-3 from the step's); fully_distributed_predict factors the raw
# B = Km + Knm' Knm / s in f32 (its means 2.4e-5 of || |Knm| |coeffs| ||)
MESH2D_F32_NOT_HELD = {"inducing": ("z",), "predict": ("means",)}


def mesh2d_value_and_grad(mesh, pack, data, kw):
    """The 2-D evidence over this rank's rows and its gradient over the
    packed hypers, in lock step over the whole mesh."""
    def f(x):
        kernel, z, s2 = pack.unpack(x)
        return sharded_log_evidence_2d(kernel, mesh, z, s2, *data,
                                       block_size=BLOCK, jitter=JITTER, **kw)

    return sharded_value_and_grad(mesh, f, pack.x0)


def all_launches(mesh, fn):
    """fn() with every launch counter of this rank set to 0 just before it;
    (fn's result, every rank's counts of the four wrappers just after)."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize(mesh.device)
    mine = torch.tensor([[w.launches for w in WRAPPERS.values()]],
                        dtype=torch.float64, device=mesh.device)
    return out, mesh.all.all_gather(mine).long().tolist()


def mesh2d_ranks(world):
    """(a)-(e) on each rank of the phase's world; rank 0's results."""
    mesh = make_mesh_2d(*MESH2D_SHAPE)
    dev = mesh.device
    X32, y32, Z = bench_data(dev)
    pack = par_model(dev, Z)
    shards = shard_batch(mesh, X32, y32)
    out = {"backend": mesh.backend, "launches": {}}
    # (a), (e): one evaluation a mode counted in every rank, then timed
    for name, kw in MESH2D_MODES.items():
        def step(kw=kw):
            return mesh2d_value_and_grad(mesh, pack, shards, kw)

        out[f"vg/{name}"], out["launches"][name] = all_launches(mesh, step)
        out[f"ms/{name}"], out[f"window/{name}"] = rank_median_ms(
            mesh, step, reps=MESH2D_TIMES)
    # (b) the f64 raw-Gram modes on the first MESH2D_F64_ROWS rows
    pack64 = make_pack(*bench_model(dev, Z, torch.float64))
    shards64 = shard_batch(mesh, X32[:MESH2D_F64_ROWS].double(),
                           y32[:MESH2D_F64_ROWS].double())
    for name, kw in MESH2D_F64_MODES.items():
        t = time.perf_counter()
        v, g = mesh2d_value_and_grad(mesh, pack64, shards64, kw)
        out[f"f64/{name}"] = (v, g, time.perf_counter() - t)
    # (c) training
    yf = bench_targets(dev, X32)
    fit_pack = make_pack(SeIso(LOG_ELL, LOG_SF2, device=dev,
                               dtype=torch.float32),
                         torch.as_tensor(Z, device=dev), 1.0)
    t = time.perf_counter()
    (*_, st), out["launches"]["fit"] = all_launches(
        mesh, lambda: fit_sharded_2d(mesh, X32, yf, fit_pack,
                                     variational=True, block_size=BLOCK,
                                     max_iter=PAR_FIT_ITERS, epsabs=1e-4))
    secs = time.perf_counter() - t
    xs = mesh.all.all_gather(st.x[None])
    out["fit"] = (float(st.f), st.n_iter, st.n_evals, secs,
                  bool(torch.all(xs == xs[0])))
    # (d) serving: conditioned on and predicting all 1M rows
    kernel, z, _ = pack.unpack(pack.x0)
    for dtype in (torch.float32, torch.float64):
        k = SeIso.of(kernel.log_ell.to(dtype), kernel.log_sf2.to(dtype))
        Xd = X32.to(dtype)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        mu, var = fully_distributed_predict(
            k, mesh, z.detach().to(dtype), SIGMA2, Xd, y32.to(dtype), Xd,
            block_size=BLOCK, jitter=JITTER)
        torch.cuda.synchronize(dev)
        out[f"predict/{dtype}"] = (mu, var, time.perf_counter() - t)
    out["staged"] = mesh.staged
    return out


def single_f64_value_and_grad(dev, Z, X, y):
    """The single-device f64 step on the card (the plain loop)."""
    pack = make_pack(*bench_model(dev, Z, torch.float64))

    def f(x):
        kernel, z, s2 = pack.unpack(x)
        return streaming.streaming_log_evidence(
            kernel, z, s2, X, y, block_size=BLOCK, jitter=JITTER)

    return pack, value_and_grad(f)(pack.x0)


def single_serving(pack, X, y, dtype):
    """predict_means_blocked and predict_variances_blocked of one card's
    streaming_trained on all rows, and the 2-norm of |Knm| |coeffs| (the
    size of the terms each mean sums, in f64)."""
    kernel, z, s2 = pack.unpack(pack.x0)
    k = SeIso.of(kernel.log_ell.detach().to(dtype),
                 kernel.log_sf2.detach().to(dtype))
    z = z.detach().to(dtype)
    Xd, yd = X.to(dtype), y.to(dtype)
    with torch.no_grad():
        trained = streaming.streaming_trained(k, z, SIGMA2, Xd, yd,
                                              jitter=JITTER, block_size=BLOCK)
        model = trained.model
        means = streaming.predict_means_blocked(k, model.inducing.z,
                                                trained.coeffs, Xd,
                                                block_size=BLOCK)
        variances = streaming.predict_variances_blocked(
            k, model.inducing.z, model.inducing.chol_km, model.r_mat, Xd,
            SIGMA2, block_size=BLOCK)
        k64 = SeIso.of(k.log_ell.double(), k.log_sf2.double())
        c64, z64 = trained.coeffs.double().abs(), z.double()
        scale = torch.cat([k64.k_cross(Xd[i:i + 65_536].double(), z64) @ c64
                           for i in range(0, Xd.shape[0], 65_536)])
    return means, variances, float(torch.linalg.norm(scale))


def mesh2d_phase(dev, card: str, data) -> None:
    """gpr_tpu_torch/parallel/mesh2d.py and dist_chol.py at bench's full
    width on a 2x2 mesh of MESH2D_RANKS gloo ranks sharing the card:
    (a)-(e) of the module docstring, each against the single-device path
    computed here first; every number is read before any check fails."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    X32, y32, Z = data
    backend = choose_backend("cuda", MESH2D_RANKS)
    pack = par_model(dev, Z)
    v_ref, g_ref = single_value_and_grad(pack, X32, y32)
    rows = MESH2D_F64_ROWS
    _, (v64_ref, g64_ref) = single_f64_value_and_grad(
        dev, Z, X32[:rows].double(), y32[:rows].double())
    yf = bench_targets(dev, X32)
    fit_pack = make_pack(SeIso(LOG_ELL, LOG_SF2, device=dev,
                               dtype=torch.float32),
                         torch.as_tensor(Z, device=dev), 1.0)
    t = time.perf_counter()
    *_, st_ref = fit(X32, yf, fit_pack, variational=True,
                     streaming_block_size=BLOCK, max_iter=PAR_FIT_ITERS,
                     epsabs=1e-4)
    fit_secs = time.perf_counter() - t
    serving = {dtype: single_serving(pack, X32, y32, dtype)
               for dtype in (torch.float32, torch.float64)}
    log(f"mesh2d references on one card: value+grad f32 {float(v_ref):.3f}, "
        f"f64 at {rows} rows {float(v64_ref):.6f}, fit {PAR_FIT_ITERS} "
        f"iterations {fit_secs:.2f} s, serving f32 and f64 "
        f"({time.perf_counter() - t_phase:.1f} s with the fit) ({card})")
    torch.cuda.empty_cache()

    sampler = clock_log()
    try:
        t = time.perf_counter()
        res = run_spmd(mesh2d_ranks, MESH2D_RANKS)
        world_secs = time.perf_counter() - t
    finally:
        samples = read_clock_log(sampler)
    log(f"mesh2d world: {MESH2D_SHAPE[0]}x{MESH2D_SHAPE[1]} mesh, "
        f"{MESH2D_RANKS} ranks, backend {res['backend']} (chosen "
        f"{backend}); {world_secs:.1f} s with the ranks' start ({card})")
    checks = [("mesh2d backend", res["backend"] == backend, res["backend"])]

    # (a) each mode against the single-device f32 step
    for name in MESH2D_MODES:
        v, g = res[f"vg/{name}"]
        rel_v = abs(float(v) - float(v_ref)) / abs(float(v_ref))
        errs = {k: rel_norm(gg, w) for (k, gg), w in zip(
            pack_groups(pack, g.to(dev)).items(),
            pack_groups(pack, g_ref).values())}
        t0, t1 = res[f"window/{name}"]
        free = MESH2D_F32_NOT_HELD.get(name, ())
        log(f"mesh2d {name} f32: evidence {float(v):.3f} against one card's "
            f"{float(v_ref):.3f} (rel {rel_v:.2e}); grad rel "
            + ", ".join(f"{k} {e:.2e}" + (" (not held in f32: held in f64 "
                                          "by (b))" if k in free else "")
                        for k, e in errs.items())
            + f"; {res[f'ms/{name}']:.2f} ms an evaluation; "
            f"{clock_window(samples, t0, t1)} ({card})")
        held = [e for k, e in errs.items() if k not in free]
        checks.append((f"mesh2d {name} f32", rel_v <= 2e-5
                       and max(held) <= 1e-3,
                       f"value rel {rel_v:.2e}, grads {errs}"))
    # (b) the f64 modes against the single-device f64 step
    for name in MESH2D_F64_MODES:
        v, g, secs = res[f"f64/{name}"]
        rel_v = abs(float(v) - float(v64_ref)) / abs(float(v64_ref))
        rel_g = rel_norm(g.to(dev), g64_ref)
        log(f"mesh2d {name} f64 at {rows} rows: evidence rel {rel_v:.2e}, "
            f"gradient rel {rel_g:.2e} from one card's f64 step, "
            f"{secs:.2f} s ({card})")
        checks.append((f"mesh2d {name} f64", rel_v <= 1e-8 and rel_g <= 1e-8,
                       f"value rel {rel_v:.2e}, gradient rel {rel_g:.2e}"))
    # (c) training
    f, n_iter, n_evals, secs, equal = res["fit"]
    log(f"mesh2d fit_sharded_2d: {n_iter} iterations, {n_evals} "
        f"evaluations, mean NLL {f:.6f} (fit on one card: "
        f"{float(st_ref.f):.6f}, {st_ref.n_iter} iterations, "
        f"{st_ref.n_evals} evaluations), x bit-equal on the {MESH2D_RANKS} "
        f"ranks: {equal}; {secs:.2f} s = {1e3 * secs / n_evals:.1f} ms an "
        f"evaluation (one card: {1e3 * fit_secs / st_ref.n_evals:.1f}) "
        f"({card})")
    checks.append(("mesh2d fit", equal and abs(f - float(st_ref.f)) <= 1e-4,
                   f"x equal {equal}, f {f} against {float(st_ref.f)}"))
    # (d) serving
    for dtype, (means, variances, scale) in serving.items():
        mu, var, secs = res[f"predict/{dtype}"]
        e_mu = float(torch.linalg.norm(mu.to(dev).double()
                                       - means.double())) / scale
        e_var = rel_norm(var.to(dev), variances)
        free = (MESH2D_F32_NOT_HELD["predict"] if dtype == torch.float32
                else ())
        log(f"mesh2d fully_distributed_predict {str(dtype)[6:]} at {N} "
            f"points: means {e_mu:.2e} of || |Knm| |coeffs| ||"
            + (" (not held in f32: held in f64 below)" if "means" in free
               else "") + f", variances rel {e_var:.2e} against one card's "
            f"blocked predictors; {secs:.2f} s ({card})")
        checks.append((f"mesh2d predict {str(dtype)[6:]}",
                       ("means" in free or e_mu <= 1e-5) and e_var <= 1e-4,
                       f"means {e_mu:.2e}, variances {e_var:.2e}"))
    # (e) launches
    launches = res["launches"]
    log(f"mesh2d launches per rank ({', '.join(WRAPPERS)}): "
        + "; ".join(f"{k} {v}" for k, v in launches.items()))
    checks.append(("mesh2d launches", all(
        c == 0 for counts in launches.values() for rank in counts
        for c in rank), f"{launches}"))
    log(f"mesh2d collectives staged through the host (all ranks' rank 0): "
        f"{res['staged'] or 'none'}")
    log(f"mesh2d phase: {time.perf_counter() - t_phase:.2f} s ({card})")
    for tag, ok, what in checks:
        check(tag, ok, what)


CLI_COMMON = ("-n-inducing", "300", "-dim-red", "8", "-log-het-sked", "-5",
              "-multiscale", "-inducing-init", "first", "-seed", "0",
              "-verbose")
CLI_DEVICE = ("-trainer", "device", "-block-size", "16384")
CLI_SHARDED = ("-trainer", "sharded", "-devices", str(PAR_RANKS),
               "-block-size", "16384")
CLI_MESH2D = ("-trainer", "sharded", "-devices",
              "{}x{}".format(*MESH2D_SHAPE), "-block-size", "16384")
CLI_FAMILY = ("-kernel", "matern52", "-n-inducing", "300", "-inducing-init",
              "first", "-seed", "0", "-verbose")
CLI_SM2 = ("-kernel", "sm2", *CLI_FAMILY[2:])
CLI_ICM = ("-kernel", "se_iso", "-tasks", str(ICM_TASKS), "-coreg-rank",
           str(ICM_RANK), *CLI_FAMILY[2:])
# the Gaussian-likelihood extensions (-exact on the first EXACT_ROWS rows)
CLI_EXT_BASE = ("-kernel", "se_iso", "-seed", "0", "-verbose")
CLI_EXT = {
    "pitc": (*CLI_EXT_BASE, "-n-inducing", "300", "-inducing-init", "first",
             "-trainer", "device", "-pitc-block", "256", "-max-iter", "2"),
    "warp": (*CLI_EXT_BASE, "-n-inducing", "300", "-inducing-init", "first",
             "-trainer", "device", "-warp", "3", "-max-iter", "5"),
    "student-t": (*CLI_EXT_BASE, "-n-inducing", "300", "-inducing-init",
                  "first", "-trainer", "device", "-student-t", "4",
                  "-max-iter", "5"),
    "exact": (*CLI_EXT_BASE, "-exact", "-max-iter", "2"),
    "exact-loo": (*CLI_EXT_BASE, "-exact", "-loo", "-max-iter", "2"),
    "exact-cg": (*CLI_EXT_BASE, "-exact", "-cg", "-n-inducing", "64",
                 "-max-iter", "5"),
}
# the Laplace modes: each trains on its CSV (the laplace phase's labels of
# the training rows) and serves the test rows
CLI_LAPLACE_BASE = (*CLI_EXT_BASE, "-n-inducing", "300", "-inducing-init",
                    "first", "-trainer", "device", "-max-iter", "2")
CLI_LAPLACE = {
    "classify": ("classify", ("-classify",)),
    "classify-stream": ("classify", ("-classify", "-block-size", "16384")),
    "poisson": ("poisson", ("-poisson",)),
    "binomial": ("binomial", ("-binomial",)),
    "negbin": ("negbin", ("-negbin", "2")),
    "ordinal": ("ordinal", ("-ordinal",)),
    "classify-ep": ("classify", ("-classify", "-approx", "ep")),
    "classify-multi": ("multi", ("-classify",)),
    "classify-multi-stream": ("multi", ("-classify", "-block-size",
                                        "16384")),
}


def cli_run(tmp, tag, argv, stdin_path):
    """Run ``python3 -m gpr_tpu_torch.cli`` on the card with ``stdin_path``
    as its standard input; (wall seconds, stdout path, stderr text)."""
    out = f"{tmp}/{tag}.out"
    t0 = time.perf_counter()
    with open(stdin_path, "rb") as fin, open(out, "wb") as fout:
        proc = subprocess.run(
            [sys.executable, "-m", "gpr_tpu_torch.cli", *argv], stdin=fin,
            stdout=fout, stderr=subprocess.PIPE, text=False, timeout=600,
            cwd=str(Path(__file__).resolve().parent))
    secs = time.perf_counter() - t0
    err = proc.stderr.decode()
    check(f"cli {tag}", proc.returncode == 0,
          f"exit {proc.returncode}: {err[-2000:]}")
    return secs, out, err


def cli_sharded_leg(tag, run, model, device_model, dev, Xtr, ytr,
                    card) -> None:
    """-trainer sharded -devices PAR_RANKS, or the 2-D mesh's DxM (its
    ranks sharing the card over gloo, or a card each over NCCL): its
    report, and its hypers against ``device_model``'s, the -trainer device
    run with the same flags and -max-iter, within 1e-6 relative."""
    secs, _, err = run
    cli_report(tag, secs, err, model, dev, Xtr, ytr, card)
    rel = rel_norm(cli_hypers(model, dev), cli_hypers(device_model, dev))
    log(f"cli {tag}: final hypers rel {rel:.3e} from the -trainer device "
        f"run {Path(device_model).stem}'s ({card})")
    check(f"cli {tag}", rel <= 1e-6, f"hypers off by rel {rel:.3e}")


def cli_artifact(path, dev):
    """(artifact, kernel, z, sigma2) of a CLI model file, in f64 on dev."""
    art, _ = load_model(path)
    return (art, *params_from_artifact(art, device=dev, dtype=torch.float64))


def cli_hypers(path, dev) -> torch.Tensor:
    """Every learned number of a CLI model file, flattened."""
    art, kernel, z, s2 = cli_artifact(path, dev)
    return torch.cat([*(t.detach().reshape(-1) for t in
                        hyper_leaves(kernel)[1]), z.reshape(-1),
                      s2.reshape(1)])


def cli_report(tag, secs, err, model, dev, Xtr, ytr, card) -> None:
    """Wall time, iterations and evaluations (the device trainer's last
    ``iter`` line; the host trainer prints no count), the final log evidence
    (recomputed here in f64 from the artifact) and the SMSE of the
    ``result:`` line."""
    art, kernel, z, s2 = cli_artifact(model, dev)
    xs = (Xtr - torch.as_tensor(art.input_means, device=dev)) / \
        torch.as_tensor(art.input_stddevs, device=dev)
    with torch.no_grad():
        l = float(streaming.streaming_log_evidence(
            kernel, z, s2, xs, ytr - art.target_mean, variational=True,
            block_size=FLAGSHIP_BLOCK))
    smse = re.findall(r"^result: .*SMSE=([0-9.eE+-]+)", err, re.M)
    steps = re.findall(r"^iter +([0-9]+): f=.* evals=([0-9]+)", err, re.M)
    counts = (f"{steps[-1][0]} iterations, {steps[-1][1]} evaluations"
              if steps else "iterations and evaluations not printed by the "
              "host trainer (-max-iter 5 bounds them)")
    log(f"cli {tag}: {secs:.2f} s wall; {counts}; log evidence {l:.3f}; "
        f"SMSE {smse[-1] if smse else 'not printed'} ({card})")
    check(f"cli {tag}", np.isfinite(l) and bool(smse), "evidence or SMSE")


def cli_ext_report(tag, secs, err, card) -> None:
    """Wall time, the last ``iter`` line's iterations and evaluations (-exact
    prints none), the ``result:`` line (-exact -cg: its ``final solve:``
    line) and, for -student-t, its weights line (for -negbin, its learned
    dispersion)."""
    steps = re.findall(r"^iter +([0-9]+): f=.* evals=([0-9]+)", err, re.M)
    result = re.findall(r"^(?:result|final solve): (.*)$", err, re.M)
    weights = re.findall(r"^((?:student-t|negbin): .*)$", err, re.M)
    counts = (f"last M-step or run {steps[-1][0]} iterations, {steps[-1][1]}"
              f" evaluations" if steps else "no iteration lines (-exact "
              "prints none)")
    log(f"cli {tag}: {secs:.2f} s wall; {counts}; result: "
        f"{result[-1] if result else 'not printed'}"
        f"{'; ' + weights[-1] if weights else ''} ({card})")
    check(f"cli {tag}", bool(result) and "nan" not in result[-1].lower(),
          "no finite result line")


def library_means(art, extra, kernel, z, xs) -> np.ndarray:
    """What -cmd test serves for an artifact, from the library: the dense
    exact posterior (``cli.serve_exact``), a warped model's observation
    mean (``warped_predict_moments``) or the predictor's means."""
    if "exact" in extra:
        return cli.serve_exact(kernel, art, xs)[0]
    dev = xs.device
    t = {k: torch.as_tensor(getattr(art, k), device=dev)
         for k in ("coeffs", "chol_km", "r_mat")}
    mu = predict_means(kernel, MeanPredictor(z=z, coeffs=t["coeffs"]), xs)
    if "warp_log_a" not in extra:
        return mu.cpu().numpy()
    wp = warp_from_jax({f: extra[f"warp_{f}"] for f in WARP_FIELDS},
                       device=dev, dtype=torch.float64)
    cvp = CoVariancePredictor(z=z, chol_km=t["chol_km"], r_mat=t["r_mat"])
    var = predict_variances(kernel, cvp, xs, art.sigma2, predictive=True)
    return warped_predict_moments(wp, mu, torch.clamp(var, min=0.0))[0]\
        .cpu().numpy()


def cli_serve(tmp, runs, dev, card, cg_runs=(), laplace=()) -> None:
    """-cmd test -with-stddev of each (tag, model, csv) of ``runs`` and of
    ``laplace`` (the Laplace modes' artifacts) and the -exact -cg tests of
    ``cg_runs`` ((tag, model, csv, flags)), the processes side by side on
    the card, then each checked (``cli_check_means``, ``cli_check_cg``,
    ``cli_check_laplace``)."""
    served = cli_side_by_side(tmp, [
        (f"test-{tag}", ("-cmd", "test", "-model", model, "-with-stddev"),
         csv) for tag, model, csv in (*runs, *laplace)] + [
        (f"test-{tag}", ("-cmd", "test", "-model", model, *flags), csv)
        for tag, model, csv, flags in cg_runs])
    for (tag, model, csv), (secs, out, _) in zip(runs, served):
        cli_check_means(tag, model, csv, secs, out, dev, card)
    for (tag, model, csv), (secs, out, _) in zip(laplace,
                                                 served[len(runs):]):
        cli_check_laplace(tag, model, csv, secs, out, dev, card)
    for (tag, model, csv, flags), (secs, out, _) in zip(
            cg_runs, served[len(runs) + len(laplace):]):
        cli_check_cg(tag, model, csv, secs, out, dev, card, bool(flags))


def cli_check_means(tag, model, csv, secs, out, dev, card) -> None:
    """What -cmd test -with-stddev printed for ``model`` on ``csv``:
    CLI_TEST finite lines with positive standard deviations, whose means
    equal the library's (``library_means``) as printed."""
    xs_raw = torch.as_tensor(native.load_csv_file(csv), device=dev)
    lines = Path(out).read_text().splitlines()
    vals = np.array([[float(v) for v in line.split(",")] for line in lines])
    art, kernel, z, _ = cli_artifact(model, dev)
    extra = load_model(model)[1]
    xs = (xs_raw - torch.as_tensor(art.input_means, device=dev)) / \
        torch.as_tensor(art.input_stddevs, device=dev)
    with torch.no_grad():
        means = library_means(art, extra, kernel, z, xs)
    want_text = [f"{v:f}" for v in means + art.target_mean]
    same = sum(line.split(",")[0] == w for line, w in zip(lines, want_text))
    log(f"cli test {tag}: {secs:.2f} s wall; {len(lines)} lines, finite "
        f"{bool(np.isfinite(vals).all())}, stddev > 0 "
        f"{bool((vals[:, 1] > 0).all())}; {same} of {CLI_TEST} means equal "
        f"to the library's as printed ({card})")
    check(f"cli test {tag}", vals.shape == (CLI_TEST, 2)
          and bool(np.isfinite(vals).all()) and same == CLI_TEST,
          f"shape {vals.shape}, {same} means equal")


def laplace_csv_columns(name, labels, rows, yf) -> list:
    """The target columns of a Laplace mode's training CSV over the first
    ``rows`` rows: 0/1 labels yf > 0 of the fit phase's targets (classify),
    else the laplace phase's labels (binomial: trials, then successes)."""
    if name == "classify":
        return [(yf[:rows] > 0).double().cpu().numpy()]
    if name == "multi":
        return [labels[name][:rows].double().cpu().numpy()]
    got = labels[name]
    if name == "binomial":
        return [got[1][:rows].cpu().numpy(), got[0][:rows].cpu().numpy()]
    return [got[:rows].cpu().numpy()]


def library_laplace(art, extra, kernel, z, xs) -> list[str]:
    """What -cmd test prints before its standard-deviation column for a
    Laplace artifact, from the library: the latent posterior of the
    artifact's state through ``predict_means``/``predict_variances``, then
    the model's own link (``mackay_squash``, EP's exact probit predictive,
    the lognormal rate or count mean, ``cell_probs``).  A multi-class
    artifact's whole line: ``multiclass_predict_from_state`` with 2,048
    draws of ``torch.Generator(...).manual_seed(0)``, then its C latent
    standard deviations."""
    dev = xs.device
    t = {k: torch.as_tensor(getattr(art, k), device=dev)
         for k in ("coeffs", "chol_km", "r_mat")}
    if "mc_a_tilde" in extra:
        probs, _, sigma = multiclass_predict_from_state(
            kernel, z, t["coeffs"],
            *(torch.as_tensor(extra[k], device=dev)
              for k in ("mc_a_tilde", "mc_b_tilde")), xs, n_samples=2048,
            generator=torch.Generator(dev).manual_seed(0))
        sd = torch.sqrt(torch.clamp(torch.diagonal(sigma, dim1=1, dim2=2),
                                    min=0.0))
        return [",".join(f"{v:f}" for v in row) for row in
                torch.cat([probs, sd], dim=1).cpu().numpy()]
    mu = predict_means(kernel, MeanPredictor(z=z, coeffs=t["coeffs"]), xs)
    var = predict_variances(kernel, CoVariancePredictor(
        z=z, chol_km=t["chol_km"], r_mat=t["r_mat"]), xs, 0.0,
        predictive=False)
    if "ordinal" in extra:
        cols = cell_probs(torch.as_tensor(extra["cutpoints"], device=dev),
                          mu, torch.clamp(var, min=1e-12))
    elif "poisson" in extra or "negbin" in extra:
        cols = torch.exp(mu + 0.5 * torch.clamp(var, min=0.0))[:, None]
    elif "ep" in extra:
        cols = torch.special.ndtr(
            mu / torch.sqrt(1.0 + torch.clamp(var, min=0.0)))[:, None]
    else:
        cols = mackay_squash(mu, torch.clamp(var, min=0.0))[:, None]
    return [",".join(f"{v:f}" for v in row) for row in cols.cpu().numpy()]


def cli_check_laplace(tag, model, csv, secs, out, dev, card) -> None:
    """What -cmd test -with-stddev printed for a Laplace artifact: CLI_TEST
    finite lines, probabilities in [0, 1], positive standard deviations,
    and every line but its last column (a multi-class artifact's whole
    line: C probabilities and C standard deviations) equal to the
    library's (``library_laplace``)."""
    xs_raw = torch.as_tensor(native.load_csv_file(csv), device=dev)
    lines = Path(out).read_text().splitlines()
    vals = np.array([[float(v) for v in line.split(",")] for line in lines])
    art, kernel, z, _ = cli_artifact(model, dev)
    extra = load_model(model)[1]
    xs = (xs_raw - torch.as_tensor(art.input_means, device=dev)) / \
        torch.as_tensor(art.input_stddevs, device=dev)
    with torch.no_grad():
        want = library_laplace(art, extra, kernel, z, xs)
    multi = "mc_a_tilde" in extra
    same = sum((line if multi else line.rsplit(",", 1)[0]) == w
               for line, w in zip(lines, want))
    probs = "poisson" not in extra and "negbin" not in extra
    p_cols = int(extra["classify"]) if multi else -1
    in_unit = (not probs) or bool(((vals[:, :p_cols] >= 0)
                                   & (vals[:, :p_cols] <= 1)).all())
    log(f"cli test {tag}: {secs:.2f} s wall; {len(lines)} lines of "
        f"{vals.shape[1] if vals.ndim == 2 else 0} columns, finite "
        f"{bool(np.isfinite(vals).all())}, stddev > 0 "
        f"{bool((vals[:, -1] > 0).all())}, in [0, 1] {in_unit}; {same} of "
        f"{CLI_TEST} lines equal to the library's as printed ({card})")
    check(f"cli test {tag}", len(lines) == CLI_TEST
          and bool(np.isfinite(vals).all()) and bool((vals[:, -1] > 0).all())
          and in_unit and same == CLI_TEST, f"{len(lines)} lines, {same} "
          "equal")


def cli_side_by_side(tmp, runs) -> list:
    """``cli_run`` for each (tag, argv, stdin path) of ``runs``, the
    processes started together on the one card; [(wall seconds, stdout
    path, stderr text)] in order.  A process's wall time includes waiting
    for the card and the host cores the others hold."""
    procs = []
    for tag, argv, stdin_path in runs:
        out = f"{tmp}/{tag}.out"
        with open(stdin_path, "rb") as fin, open(out, "wb") as fout:
            procs.append((tag, out, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "gpr_tpu_torch.cli", *argv],
                stdin=fin, stdout=fout, stderr=subprocess.PIPE,
                cwd=str(Path(__file__).resolve().parent))))
    results = []
    try:
        for tag, out, t0, proc in procs:
            err = proc.communicate(timeout=600)[1].decode()
            secs = time.perf_counter() - t0
            check(f"cli {tag}", proc.returncode == 0,
                  f"exit {proc.returncode}: {err[-2000:]}")
            results.append((secs, out, err))
    finally:  # a failed command stops the others
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def cli_laplace_runs(tmp, dev, data, Xtr) -> list:
    """The Laplace modes' trainings (CLI_LAPLACE) for ``cli_side_by_side``,
    each on the laplace phase's labels of the training rows (the
    multi-class modes on bench's multi-class labels), its CSV written
    here."""
    labels = laplace_data(dev, data[0], data[1])
    labels["multi"] = multi_labels(data[0][:Xtr.shape[0]])
    yf = bench_targets(dev, data[0])
    runs = []
    for tag, (name, flags) in CLI_LAPLACE.items():
        csv = f"{tmp}/train_{name}.csv"
        if not Path(csv).exists():
            np.savetxt(csv, np.column_stack([
                Xtr.cpu().numpy(),
                *laplace_csv_columns(name, labels, Xtr.shape[0], yf)]),
                fmt="%.9g", delimiter=",")
        runs.append((tag, ("-cmd", "train", "-model", f"{tmp}/{tag}.npz",
                           *CLI_LAPLACE_BASE, *flags), csv))
    return runs


def cli_coregionalization(err) -> np.ndarray:
    """The B matrix that ``-tasks -verbose`` prints on stderr."""
    text = err[err.index("coregionalization B"):err.index("inter-task")]
    return np.array([[float(v) for v in line.split()]
                     for line in text.splitlines()[1:]])


# -- cli helpers of the iterative exact GP's artifact
CLI_CG_STDDEV = 2_048  # test rows the -with-stddev leg serves (CG solves)


def cli_check_cg(tag, model, csv, secs, out, dev, card, with_stddev) -> None:
    """What -cmd test printed for an exact_cg artifact: finite lines whose
    means equal, as printed, the library's ``predict_means_iter`` on the
    artifact (and, with -with-stddev, positive standard deviations)."""
    xs_raw = torch.as_tensor(native.load_csv_file(csv), device=dev)
    lines = Path(out).read_text().splitlines()
    vals = np.array([[float(v) for v in line.split(",")] for line in lines])
    art, kernel, z, s2 = cli_artifact(model, dev)
    xs = (xs_raw - torch.as_tensor(art.input_means, device=dev)) / \
        torch.as_tensor(art.input_stddevs, device=dev)
    tr = iterative.IterTrained(z=z, sigma2=s2, alpha=torch.as_tensor(
        art.coeffs, device=dev), iters=0, relres=s2)
    means = iterative.predict_means_iter(kernel, tr, xs).cpu().numpy()
    want = [f"{v:f}" for v in means + art.target_mean]
    same = sum(line.split(",")[0] == w for line, w in zip(lines, want))
    cols = 2 if with_stddev else 1
    sd_ok = (not with_stddev) or bool((vals[:, 1] > 0).all())
    log(f"cli test {tag}: {secs:.2f} s wall; {len(lines)} lines of {cols} "
        f"columns, finite {bool(np.isfinite(vals).all())}, stddev > 0 "
        f"{sd_ok}; {same} of {len(want)} means equal to the library's "
        f"predict_means_iter as printed ({card})")
    check(f"cli test {tag}", vals.shape == (len(want), cols)
          and bool(np.isfinite(vals).all()) and sd_ok and same == len(want),
          f"shape {vals.shape}, {same} means equal")


def cli_cg_runs(tmp, model, test_csv, Xte) -> tuple:
    """The -cmd test runs of the -exact -cg artifact for ``cli_serve``: the
    means of the CLI_TEST rows, and with -with-stddev (a CG solve per
    CLI_CG_STDDEV points) the first CLI_CG_STDDEV rows."""
    small = f"{tmp}/test_cg.csv"
    np.savetxt(small, Xte[:CLI_CG_STDDEV], fmt="%.9g", delimiter=",")
    return (("exact-cg", model, test_csv, ()),
            ("exact-cg-stddev", model, small, ("-with-stddev",)))


def cli_phase(dev, card: str, data) -> None:
    """The command line in four waves of processes side by side on the
    card: the host, device and checkpointed device trainers; then (after
    one bare process alone) the resumed trainer with the other regression
    and extension trainings; then the Laplace modes' trainings; then every
    test.  (The exact GP's legs and the Laplace modes' dense trainings do
    not fit the card's memory together.)"""
    # the commands' processes share the card: hand back what this process
    # holds in PyTorch's cache (the exact GP's leg takes ~30 GiB)
    torch.cuda.empty_cache()
    X32, _, _ = data
    yf = bench_targets(dev, X32)
    Xtr = X32[:CLI_TRAIN].double()
    ytr = yf[:CLI_TRAIN].double()
    Xte = X32[CLI_TRAIN:CLI_TRAIN + CLI_TEST].cpu().numpy()
    # bench's ICM rows: its task ids as a last input column
    tid = bench_task_ids()[0]
    Xtr_icm = torch.cat([Xtr, torch.as_tensor(
        tid[:CLI_TRAIN], dtype=torch.float64, device=dev)[:, None]], dim=1)
    Xte_icm = np.column_stack([Xte, tid[CLI_TRAIN:CLI_TRAIN + CLI_TEST]])
    t0 = time.perf_counter()
    parser = native.get_lib()
    with tempfile.TemporaryDirectory() as tmp:
        train_csv, test_csv = f"{tmp}/train.csv", f"{tmp}/test.csv"
        icm_csv, icm_test_csv = f"{tmp}/train_icm.csv", f"{tmp}/test_icm.csv"
        exact_csv = f"{tmp}/train_exact.csv"
        for path, cols in ((train_csv, [Xtr, ytr]), (test_csv, [Xte]),
                           (icm_csv, [Xtr_icm, ytr]),
                           (icm_test_csv, [Xte_icm]),
                           (exact_csv, [Xtr[:EXACT_ROWS], ytr[:EXACT_ROWS]])):
            np.savetxt(path, np.column_stack([
                c.cpu().numpy() if torch.is_tensor(c) else c for c in cols]),
                fmt="%.9g", delimiter=",")
        laplace_runs = cli_laplace_runs(tmp, dev, data, Xtr)
        which = f"native {Path(parser._name).name}" if parser else "python"
        log(f"cli data: {CLI_TRAIN} training rows and {CLI_TEST} test rows "
            f"of bench's draw, without and with its ICM task column, the "
            f"Laplace modes' labels, written in "
            f"{time.perf_counter() - t0:.2f} s; csv parser: {which}")

        def argv(tag, *flags):
            common = () if "-kernel" in flags else CLI_COMMON
            return ("-cmd", "train", "-model", f"{tmp}/{tag}.npz", *common,
                    *flags)

        # wave 1: the host and device trainers, and the device trainer
        # stopped by -max-iter 2 with a checkpoint
        ckpt = f"{tmp}/device.ckpt.npz"
        first = (("host", ("-max-iter", "5")),
                 ("device", (*CLI_DEVICE, "-max-iter", "5")),
                 ("device-part", (*CLI_DEVICE, "-max-iter", "2",
                                  "-checkpoint", ckpt)))
        t1 = time.perf_counter()
        done = cli_side_by_side(tmp, [(tag, argv(tag, *flags), train_csv)
                                      for tag, flags in first])
        log(f"cli wave 1: {len(first)} trainings side by side in "
            f"{time.perf_counter() - t1:.2f} s ({card})")
        for (tag, _), (secs, _, err) in zip(first, done):
            cli_report(tag, secs, err, f"{tmp}/{tag}.npz", dev, Xtr, ytr,
                       card)
        host, full = f"{tmp}/host.npz", f"{tmp}/device.npz"

        # a process that does next to nothing, alone: what every command
        # pays to start (interpreter, torch, the card's context)
        one_row = f"{tmp}/one.csv"
        np.savetxt(one_row, Xte[:1], fmt="%.9g", delimiter=",")
        secs, _, _ = cli_run(tmp, "start", ("-cmd", "test", "-model", host),
                             one_row)
        log(f"cli start-up: {secs:.2f} s wall for -cmd test on one row "
            f"({card})")

        # wave 2: the resumed trainer beside a base family other than
        # se_fat, the spectral mixture (its keyless init from the data's
        # spectrum), the ICM model, the Gaussian-likelihood extensions
        # (-exact on the first EXACT_ROWS training rows) and the sharded
        # trainers (the 1-D mesh, and the mesh2d phase's (f): the 2-D
        # mesh, stopped at -max-iter 2 and held against wave 1's
        # device-part)
        fam_runs = (
            ("matern52", (*CLI_FAMILY, *CLI_DEVICE), train_csv, Xtr),
            ("sm2", (*CLI_SM2, *CLI_DEVICE), train_csv, Xtr),
            ("icm", (*CLI_ICM, *CLI_DEVICE), icm_csv, Xtr_icm))
        ext_runs = tuple((tag, flags, exact_csv if "-exact" in flags
                          else train_csv) for tag, flags in CLI_EXT.items())
        resumed = f"{tmp}/device-resumed.npz"
        sharded = f"{tmp}/sharded.npz"
        sharded_2d = f"{tmp}/sharded-2x2.npz"
        runs = (
            [("device-resumed", argv("device-resumed", *CLI_DEVICE,
                                     "-max-iter", "5", "-checkpoint", ckpt,
                                     "-resume"), train_csv)]
            + [(tag, argv(tag, *flags, "-max-iter", "5"), csv)
               for tag, flags, csv, _ in fam_runs]
            + [(tag, argv(tag, *flags), csv) for tag, flags, csv in ext_runs]
            + [("sharded", argv("sharded", *CLI_SHARDED, "-max-iter", "5"),
                train_csv),
               ("sharded-2x2", argv("sharded-2x2", *CLI_MESH2D,
                                    "-max-iter", "2"), train_csv)])
        t1 = time.perf_counter()
        trained = dict(zip([tag for tag, _, _ in runs],
                           cli_side_by_side(tmp, runs)))
        log(f"cli wave 2: {len(runs)} trainings side by side in "
            f"{time.perf_counter() - t1:.2f} s ({card})")
        cli_report("device-resumed", *trained["device-resumed"][::2],
                   resumed, dev, Xtr, ytr, card)
        got, want = cli_hypers(resumed, dev), cli_hypers(full, dev)
        rel = rel_norm(got, want)
        same = ("bit-equal to" if torch.equal(got, want)
                else f"rel {rel:.3e} from")
        log(f"cli resume: final hypers {same} the uninterrupted device "
            f"run's ({card})")
        check("cli resume", rel <= 1e-6, f"hypers off by rel {rel:.3e}")
        for tag, _, _, x in fam_runs:
            cli_report(tag, *trained[tag][::2], f"{tmp}/{tag}.npz", dev, x,
                       ytr, card)
        B = cli_coregionalization(trained["icm"][2])
        log(f"cli icm coregionalization B: "
            f"{np.array2string(B, precision=4, separator=', ')} ({card})")
        check("cli icm B", B.shape == (ICM_TASKS, ICM_TASKS)
              and bool(np.isfinite(B).all()), f"B of shape {B.shape}")
        cli_sharded_leg("sharded", trained["sharded"], sharded, full, dev,
                        Xtr, ytr, card)
        cli_sharded_leg("sharded-2x2", trained["sharded-2x2"], sharded_2d,
                        f"{tmp}/device-part.npz", dev, Xtr, ytr, card)
        ext_models = []
        for tag, _, _ in ext_runs:
            cli_ext_report(tag, *trained[tag][::2], card)
            if tag != "exact-cg":  # served below: its CG variances
                ext_models.append((tag, f"{tmp}/{tag}.npz", test_csv))
        # wave 3: the Laplace modes
        t1 = time.perf_counter()
        for (tag, _, _), (secs, _, err) in zip(
                laplace_runs, cli_side_by_side(tmp, laplace_runs)):
            cli_ext_report(tag, secs, err, card)
        log(f"cli wave 3: {len(laplace_runs)} trainings side by side in "
            f"{time.perf_counter() - t1:.2f} s ({card})")

        # wave 4: every test
        t1 = time.perf_counter()
        cg_runs = cli_cg_runs(tmp, f"{tmp}/exact-cg.npz", test_csv, Xte)
        regression = (("host", host, test_csv),
                      ("device-resumed", resumed, test_csv),
                      *((tag, f"{tmp}/{tag}.npz", test_csv)
                        for tag in ("matern52", "sm2")),
                      ("icm", f"{tmp}/icm.npz", icm_test_csv),
                      ("sharded-2x2", sharded_2d, test_csv), *ext_models)
        laplace = tuple((tag, f"{tmp}/{tag}.npz", test_csv)
                        for tag, _, _ in laplace_runs)
        cli_serve(tmp, regression, dev, card, cg_runs, laplace)
        log(f"cli wave 4: {len(regression) + len(laplace) + len(cg_runs)} "
            f"tests side by side, checked, in "
            f"{time.perf_counter() - t1:.2f} s ({card})")
    log(f"cli phase: {time.perf_counter() - t0:.2f} s ({card})")


def main() -> int:
    card = device_phase()
    dev = torch.device("cuda", 0)
    seconds = {}  # each phase's wall, for the summary line

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    timed("build", build_phase)
    timed("kernels", kernels_phase, dev)
    timed("bwd", bwd_phase, dev)
    data = bench_data(dev)
    rows = timed("slice", slice_phase, dev, card, data)
    rows.append(timed("step", step_phase, dev, card, data))
    timed("fit", fit_phase, dev, card, data)
    rows.append(timed("roofline", roofline_phase, dev, card))
    for name, phase in (("restarts", restarts_phase),
                        ("quickstart", quickstart_phase),
                        ("flagship", flagship_phase),
                        ("route", route_phase),
                        ("families", families_phase),
                        ("composites", composites_phase),
                        ("hetero", hetero_phase),
                        ("gaussian_ext", gaussian_ext_phase),
                        ("laplace", laplace_phase),
                        ("classify_ext", classify_ext_phase),
                        ("iterative", iterative_phase),
                        ("hmc", hmc_phase),
                        ("parallel", parallel_phase),
                        ("mesh2d", mesh2d_phase),
                        ("cli", cli_phase)):
        timed(name, phase, dev, card, data)
    log(f"phase seconds: {json.dumps(seconds)}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
