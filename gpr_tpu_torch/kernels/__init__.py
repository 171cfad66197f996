from .base import sqdist
from .se_fat import SeFat
from .se_iso import SeIso

#: Kernel families ported so far, by name.
FAMILIES = {SeIso.name: SeIso, SeFat.name: SeFat}


def resolve_family(name: str):
    """Kernel class for ``name``.  ``se_iso`` and ``se_fat`` are ported;
    the other families and the combinators are queued in ROADMAP.md."""
    try:
        return FAMILIES[name]
    except KeyError:
        raise NotImplementedError(
            f"kernel family {name!r} is not ported to gpr_tpu_torch yet "
            f"(ported: {sorted(FAMILIES)}; see ROADMAP.md, queue 1 item 8)"
        ) from None


__all__ = ["FAMILIES", "SeFat", "SeIso", "resolve_family", "sqdist"]
