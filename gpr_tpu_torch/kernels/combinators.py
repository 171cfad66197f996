"""Kernel combinators: sum, product and column-restricted covariance
families.  The counterpart of ``gpr_tpu/kernels/combinators.py``.

Sums and elementwise products of covariance functions are covariance
functions, so every engine path (dense and streaming evidence, serving,
training, checkpoints) takes a combinator as it takes a base family.  A
trend is ``sum(se_iso,lin_ard)``, quasi-periodic structure
``prod(periodic,se_iso)``, the spectral mixture a sum of
``prod(se_ard,cosine)`` and the ICM multi-output model
``prod(cols(task(T,R),d,d+1),cols(se_iso,0,d))``.

A family is a class, as a base family is: ``sum_family``,
``product_family`` and ``cols_family`` intern one subclass of
:class:`Combinator` per structure (the counterpart of JAX's ``_make``), so
``type(kernel)`` answers ``name``, ``param_names`` and ``default_params``
for a combinator as for ``SeIso``.  An instance holds its term modules in
``terms`` (an ``nn.ModuleList``).

Hyper fields have dotted names, as JAX's checkpoint spells them:
``terms.0.log_ell``, ``terms.1.terms.0.W``.  ``param_names`` lists them in
the order of JAX's ravel of ``{"terms": (...)}``: term by term, each base
term's fields in its ``Params`` declaration order
(``base.declared_names``), not sorted.  A packed vector, the streaming
VJP's accumulators and an artifact's arrays all read that one list.

Inducing representation: the raw input-space Z.  Each method re-derives
every term's own representation (``term.inducing_from_inputs``), and
``cols`` slices columns [lo, hi) of X and Z first, so Z gradients flow
through each term's transform and only into the columns it sees.
"""

from __future__ import annotations

from torch import nn

from .base import cross_inputs, declared_names, k_upper_cols, view_of


def _term_fields(fields: dict, i: int) -> dict:
    """The fields of term ``i``, their ``terms.i.`` prefix stripped."""
    prefix = f"terms.{i}."
    return {k[len(prefix):]: v for k, v in fields.items()
            if k.startswith(prefix)}


def _check_fields(cls, fields: dict):
    known = set(cls.param_names) | set(cls.static_names)
    unknown = set(fields) - known
    if unknown:
        raise TypeError(f"{cls.name} has no fields {sorted(unknown)}")


class Combinator(nn.Module):
    """Body of every combinator family; ``sum_family``, ``product_family``
    and ``cols_family`` make the interned subclasses.

    ``Combinator(*terms)`` composes term modules (instances of
    ``term_families``, in order); ``Combinator(**fields)`` builds the terms
    from dotted field names, as ``convert.from_jax_params`` does.
    """

    name: str
    #: "sum", "prod" or "cols"
    op: str
    #: the term families (classes), in order
    term_families: tuple
    #: cols' column range [lo, hi); None for sum and prod
    cols: tuple | None = None
    param_names: tuple
    declared_names: tuple
    static_names: tuple
    optional_names: tuple
    learn_inducing_default: bool

    def __init__(self, *terms, device="cuda", dtype=None, **fields):
        """On the card unless ``device`` says otherwise (``"cpu"`` for CPU
        work); ``device`` and ``dtype`` apply to terms built from
        ``fields``."""
        super().__init__()
        cls = type(self)
        if terms and fields:
            raise TypeError(f"{cls.name}: give term modules or fields, "
                            "not both")
        if not terms:
            _check_fields(cls, fields)
            terms = [fam(**_term_fields(fields, i), device=device,
                         dtype=dtype)
                     for i, fam in enumerate(cls.term_families)]
        if [type(t) for t in terms] != list(cls.term_families):
            raise TypeError(
                f"{cls.name} takes terms of "
                f"{[f.name for f in cls.term_families]}, got "
                f"{[getattr(t, 'name', t) for t in terms]}")
        self.terms = nn.ModuleList(terms)

    @classmethod
    def of(cls, **fields) -> "Combinator":
        """A kernel whose hypers ARE the given tensors, by dotted name: each
        term is its family's view (``of``)."""
        _check_fields(cls, fields)
        return view_of(cls, terms=nn.ModuleList(
            fam.of(**_term_fields(fields, i))
            for i, fam in enumerate(cls.term_families)))

    @classmethod
    def default_params(cls, X, n_inducing: int, generator=None):
        """Each term's defaults (on its columns, for cols), in term order.
        A term that draws takes its draws from ``generator``, consumed term
        by term: where JAX splits one key per term, the draws differ."""
        Xs = cls._s(X)
        return cls(*(fam.default_params(Xs, n_inducing, generator)
                     for fam in cls.term_families))

    @classmethod
    def _s(cls, A):
        return A if cls.cols is None else A[..., cls.cols[0]:cls.cols[1]]

    def _each(self, fn):
        parts = [fn(t) for t in self.terms]
        out = parts[0]
        for p in parts[1:]:
            out = out * p if self.op == "prod" else out + p
        return out

    # -- the kernel protocol ----------------------------------------------

    def inducing_from_inputs(self, X):
        """Raw input space; every term re-derives its own representation."""
        return X

    def k_upper(self, z):
        zs = self._s(z)
        return self._each(lambda t: t.k_upper(t.inducing_from_inputs(zs)))

    def k_diag(self, X):
        Xs = self._s(X)
        return self._each(lambda t: t.k_diag(Xs))

    def k_cross(self, X, z):
        Xs, zs = self._s(X), self._s(z)
        return self._each(
            lambda t: t.k_cross(Xs, t.inducing_from_inputs(zs)))

    def k_upper_inputs(self, X):
        Xs = self._s(X)
        return self._each(lambda t: t.k_upper_inputs(Xs))

    def k_cross_inputs(self, X1, X2):
        X1s, X2s = self._s(X1), self._s(X2)
        return self._each(lambda t: cross_inputs(t, X1s, X2s))

    def k_one(self, x):
        xs = self._s(x)
        return self._each(lambda t: t.k_one(xs))

    def k_upper_cols(self, z, j0: int, m_t: int):
        """Columns [j0, j0 + m_t) of ``k_upper`` from the terms' blocks."""
        zs = self._s(z)
        return self._each(lambda t: k_upper_cols(
            t, t.inducing_from_inputs(zs), j0, m_t))


_INTERNED: dict = {}


def _make(op: str, terms: tuple, cols: tuple | None = None):
    key = (op, terms, cols)
    cls = _INTERNED.get(key)
    if cls is None:
        inner = ",".join(t.name for t in terms)
        name = (f"{op}({inner})" if cols is None
                else f"cols({inner},{cols[0]},{cols[1]})")

        def dotted(names_of):
            return tuple(f"terms.{i}.{n}" for i, t in enumerate(terms)
                         for n in names_of(t))

        leaves = dotted(declared_names)
        cls = _INTERNED[key] = type(name, (Combinator,), {
            "__doc__": f"The ``{name}`` covariance family.",
            "name": name, "op": op, "term_families": terms, "cols": cols,
            "param_names": leaves, "declared_names": leaves,
            "static_names": dotted(lambda t: t.static_names),
            "optional_names": dotted(lambda t: t.optional_names),
            "learn_inducing_default": any(t.learn_inducing_default
                                          for t in terms),
        })
    return cls


def sum_family(*terms):
    """Covariance sum k = k_1 + k_2 + ... (at least two terms)."""
    if len(terms) < 2:
        raise ValueError("sum_family needs at least two terms")
    return _make("sum", tuple(terms))


def product_family(*terms):
    """Covariance product k = k_1 * k_2 * ... (Schur product theorem)."""
    if len(terms) < 2:
        raise ValueError("product_family needs at least two terms")
    return _make("prod", tuple(terms))


def cols_family(term, lo: int, hi: int):
    """``term`` restricted to input columns [lo, hi)."""
    if not 0 <= int(lo) < int(hi):
        raise ValueError("cols needs 0 <= lo < hi")
    return _make("cols", (term,), (int(lo), int(hi)))


def _split_top(inner: str) -> list[str]:
    """Split on top-level commas (paren-depth aware)."""
    args, depth, start = [], 0, 0
    for i, ch in enumerate(inner):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            args.append(inner[start:i])
            start = i + 1
    args.append(inner[start:])
    return args


def parse_family(name: str, base: dict):
    """Parse a structural kernel name back into a family class.

    Grammar (nested arbitrarily), e.g. ``sum(prod(periodic,se_iso),lin_one)``
    or ``prod(cols(task(2,1),8,9),cols(se_iso,0,8))``:

        NAME | sum(K,K,...) | prod(K,K,...) | cols(K,lo,hi) | task(T,R)

    ``base`` is the flat registry of base families (``kernels.FAMILIES``).
    """
    name = name.strip()
    if name in base:
        return base[name]
    for op in ("sum", "prod"):
        if name.startswith(op + "(") and name.endswith(")"):
            args = _split_top(name[len(op) + 1:-1])
            return _make(op, tuple(parse_family(a, base) for a in args))
    if name.startswith("cols(") and name.endswith(")"):
        args = _split_top(name[5:-1])
        if len(args) != 3:
            raise KeyError(f"cols(...) takes (kernel, lo, hi): {name!r}")
        return cols_family(parse_family(args[0], base), int(args[1]),
                           int(args[2]))
    if name.startswith("task(") and name.endswith(")"):
        args = _split_top(name[5:-1])
        if len(args) != 2:
            raise KeyError(f"task(...) takes (n_tasks, rank): {name!r}")
        from .task import task_family

        return task_family(int(args[0]), int(args[1]))
    raise KeyError(
        f"unknown kernel family {name!r}: not a base family "
        f"({', '.join(sorted(base))}) nor "
        f"sum(...)/prod(...)/cols(...)/task(...)"
    )
