from .base import choose_subset, sqdist, weighted_eval, weighted_eval_one
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

#: Kernel families ported so far, by name: the JAX package's base families
#: (the reference's five and its six extensions).
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


def resolve_family(name: str):
    """Kernel class for ``name``.  Every base family is ported; the
    combinators (``sum(...)``, ``prod(...)``, ``cols(...)``), the task
    family and the spectral mixture are queued in ROADMAP.md."""
    try:
        return FAMILIES[name]
    except KeyError:
        raise NotImplementedError(
            f"kernel family {name!r} is not ported to gpr_tpu_torch yet "
            f"(ported: {sorted(FAMILIES)}; see ROADMAP.md, queue 1 item 8)"
        ) from None


__all__ = ["FAMILIES", "Const", "Cosine", "LinArd", "LinOne", "Matern32",
           "Matern52", "Periodic", "RatQuad", "SeArd", "SeFat", "SeIso",
           "choose_subset", "resolve_family", "sqdist", "weighted_eval",
           "weighted_eval_one"]
