from .lbfgs_device import (
    LBFGSDeviceState,
    fit,
    fit_packed_objective,
    minimize_lbfgs_device,
)
from .pack import HyperPack, make_pack
from .priors import field_priors, normal, soft_box

__all__ = [n for n in dir() if not n.startswith("_")]
