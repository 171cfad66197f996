from .base import (
    choose_subset,
    cross_inputs,
    k_upper_cols,
    sqdist,
    weighted_eval,
    weighted_eval_one,
)
from .combinators import cols_family, parse_family, product_family, sum_family
from .const import Const
from .cosine import Cosine
from .lin_ard import LinArd
from .lin_one import LinOne
from .matern import Matern32, Matern52
from .periodic import Periodic
from .rq import RatQuad
from .se_ard import SeArd
from .se_fat import SeFat
from .se_iso import SeIso
from .sm_init import sm_init_from_data, sm_spectrum
from .task import task_family

#: The base families by name: the reference's five and the JAX package's
#: six extensions.
FAMILIES = {
    Const.name: Const,
    LinOne.name: LinOne,
    LinArd.name: LinArd,
    SeIso.name: SeIso,
    SeFat.name: SeFat,
    Matern32.name: Matern32,
    Matern52.name: Matern52,
    RatQuad.name: RatQuad,
    Periodic.name: Periodic,
    SeArd.name: SeArd,
    Cosine.name: Cosine,
}


def sm_family(q: int):
    """Spectral-mixture kernel with ``q`` components (Wilson & Adams 2013,
    vector-mean form): the sum of q ``prod(se_ard,cosine)`` terms, each a
    Gaussian spectral peak with learnable location (cosine.mu), widths
    (se_ard lengthscales) and weight (se_ard sf2); q = 1 is the product
    itself.  Initialize it from the data with ``sm_init_from_data``."""
    if q < 1:
        raise ValueError("sm_family needs q >= 1")
    comp = product_family(SeArd, Cosine)
    if q == 1:
        return comp
    return sum_family(*([comp] * q))


def icm_family(data_family, n_features: int, n_tasks: int, rank: int = 1):
    """Intrinsic coregionalization model over stacked multi-output rows
    ``[features..., task_id]``: k = B[t, t'] k_data(x, x') with B = W W' +
    diag(kappa) (``kernels/task.py``)."""
    return product_family(
        cols_family(task_family(n_tasks, rank), n_features, n_features + 1),
        cols_family(data_family, 0, n_features),
    )


def resolve_family(name: str):
    """Kernel class for ``name``: a base family or a structural name such
    as ``sum(se_iso,lin_ard)`` (``combinators.parse_family``), the inverse
    of ``family.name``.  An unknown name raises KeyError."""
    return parse_family(name, FAMILIES)


__all__ = ["FAMILIES", "Const", "Cosine", "LinArd", "LinOne", "Matern32",
           "Matern52", "Periodic", "RatQuad", "SeArd", "SeFat", "SeIso",
           "choose_subset", "cols_family", "cross_inputs", "icm_family",
           "k_upper_cols", "parse_family", "product_family",
           "resolve_family", "sm_family", "sm_init_from_data", "sm_spectrum",
           "sqdist", "sum_family", "task_family", "weighted_eval",
           "weighted_eval_one"]
