from .base import sqdist
from .se_iso import SeIso

#: Kernel families ported so far, by name.
FAMILIES = {SeIso.name: SeIso}


def resolve_family(name: str):
    """Kernel class for ``name``.  Only ``se_iso`` is ported; the other
    families and the combinators are queued in ROADMAP.md."""
    try:
        return FAMILIES[name]
    except KeyError:
        raise NotImplementedError(
            f"kernel family {name!r} is not ported to gpr_tpu_torch yet "
            f"(ported: {sorted(FAMILIES)}; see ROADMAP.md, queue 1)"
        ) from None


__all__ = ["FAMILIES", "SeIso", "resolve_family", "sqdist"]
