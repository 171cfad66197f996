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
from .loo import (
    loo_log_likelihood as loo_log_likelihood_fitc,
    loo_objective as loo_objective_fitc,
    loo_posterior as loo_posterior_fitc,
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

__all__ = [n for n in dir() if not n.startswith("_")]
