from .binomial import (
    binomial_laplace_mode,
    binomial_log_evidence,
    binomial_newton_scan,
    binomial_predict,
    fit_binomial,
)
from .classify import (
    classify_log_evidence,
    classify_predict,
    fit_classify,
    laplace_mode,
    newton_scan,
)
from .classify_ep import (
    ep_log_evidence,
    ep_log_evidence_from_sites,
    ep_posterior_state,
    ep_predict,
    ep_sweeps,
    fit_classify_ep,
)
from .classify_multi import (
    SoftmaxFixedPoint,
    fit_classify_multi,
    mc_softmax_probs,
    multiclass_log_evidence,
    multiclass_posterior_state,
    multiclass_predict,
    multiclass_predict_from_state,
    softmax_newton_scan,
)
from .classify_multi_stream import (
    StreamSoftmaxFixedPoint,
    stream_multiclass_log_evidence,
    stream_multiclass_parts,
    stream_multiclass_predict,
    stream_multiclass_state,
)
from .classify_stream import (
    newton_scan_stream,
    stream_classify_log_evidence,
    stream_classify_parts,
    stream_classify_predict,
    stream_laplace_log_evidence,
    stream_laplace_parts,
    stream_prior_diag,
)
from .exact import (
    ExactModel,
    ExactTrained,
    calc_exact,
    covariances_exact,
    exact_trained,
    fit_exact,
    log_evidence_exact,
    loo_log_likelihood,
    loo_objective_exact,
    loo_posterior,
    predict_means_exact,
    predict_variances_exact,
)
from .fitc import (
    InducingState,
    ModelState,
    TrainedState,
    calc_inducing,
    calc_means,
    calc_model,
    calc_trained,
    choose_kmeans_inputs,
    choose_n_first_inputs,
    choose_n_random_inputs,
    co_variance_coeffs,
    log_evidence,
    update_sigma2,
)
from .ift import (
    LaplaceFixedPoint,
    fitc_kdot,
    laplace_evidence_core,
    laplace_mode_generic,
    make_binv,
    newton_scan_generic,
)
from .iterative import (
    IterTrained,
    NystromPrecond,
    evidence_grads_iter,
    fit_iter,
    iter_trained,
    kernel_matvec,
    nystrom_precond,
    pcg,
    predict_means_iter,
    predict_variances_iter,
    sgd_update,
)
from .loo import (
    loo_log_likelihood as loo_log_likelihood_fitc,
    loo_objective as loo_objective_fitc,
    loo_posterior as loo_posterior_fitc,
)
from .multitask import batched_log_evidence, batched_value_and_grad, multi_start
from .negbin import (
    fit_negbin,
    negbin_laplace_mode,
    negbin_log_evidence,
    negbin_newton_scan,
    negbin_predict,
)
from .online import (
    OnlineState,
    online_downdate,
    online_init,
    online_log_evidence,
    online_predictors,
    online_update,
)
from .ordinal import (
    cutpoints_from_raw,
    default_cutpoint_raw,
    fit_ordinal,
    ordinal_laplace_mode,
    ordinal_log_evidence,
    ordinal_newton_scan,
    ordinal_predict,
)
from .pitc import pitc_coeffs, pitc_log_evidence, pitc_stream_stats
from .poisson import (
    fit_poisson,
    poisson_laplace_mode,
    poisson_log_evidence,
    poisson_newton_scan,
    poisson_predict,
)
from .predict import (
    CoVariancePredictor,
    MeanPredictor,
    co_variance_predictor,
    covariances_fic,
    covariances_fic_model_inputs,
    covariances_fitc,
    covariances_fitc_model_inputs,
    mean_predictor,
    predict_mean_one,
    predict_means,
    predict_variance_one,
    predict_variances,
    variances_model_inputs,
)
from .robust import (
    fit_t,
    t_elbo,
    t_em_sweeps,
    t_lambda_update,
    t_posterior_moments,
    t_predict,
    t_select_nu,
)
from .sample import (CovSampler, Sampler, cov_sample, cov_sampler,
                     sample, sample_fic_blocked, sampler)
from .stats import ClassifyStats, Stats, calc_classify_stats, calc_stats
from .streaming import (
    StreamingTrained,
    StreamStats,
    predict_means_blocked,
    predict_variances_blocked,
    stream_stats,
    streaming_coeffs,
    streaming_log_evidence,
    streaming_trained,
)
from .warped import (
    WarpParams,
    default_warp_params,
    fit_warped,
    make_warped_pack,
    warp,
    warp_deriv,
    warp_inv,
    warped_log_evidence,
    warped_predict_mean,
    warped_predict_median,
    warped_predict_moments,
    warped_predict_quantile,
)

__all__ = [n for n in dir() if not n.startswith("_")]
