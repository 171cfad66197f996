from .hmc import (
    HMCResult,
    bulk_ess,
    hmc,
    make_accept_energy,
    predict_hmc_mixture,
    sample_posterior,
    split_rhat,
)
from .lbfgs import LBFGSHostState, LBFGSResult, minimize_lbfgs
from .lbfgs_device import (
    LBFGSDeviceState,
    ProbeReport,
    fit,
    fit_packed_objective,
    fit_restarts,
    minimize_lbfgs_device,
    value_and_grad,
)
from .pack import ExtendedPack, HyperPack, extend_pack, make_pack
from .polish import PolishReport, evaluate_f64, polish
from .priors import field_priors, normal, soft_box
from .sgd_smd import (
    SGDState,
    SMDState,
    run_ascent,
    sgd_create,
    sgd_step,
    smd_create,
    smd_step,
)
from .train import (
    Bailout,
    TrainResult,
    default_n_inducing,
    default_sigma2,
    make_objective,
    train,
    train_sgd,
    train_smd,
)

__all__ = [n for n in dir() if not n.startswith("_")]
