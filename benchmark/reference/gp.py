"""FITC / variational-FIC evidence, gradient and predictors in plain
PyTorch, from the equations alone (the OCaml-GPR model the program ports;
``gpr_tpu_torch/models/fitc.py`` states the same ones):

    Kj = K(Z, Z) + jitter I,   L = chol(Kj) (lower)
    r  = kdiag - rowsq(Knm L^-T),   s = r + sigma2,   is = 1 / s
    B  = Kj + Knm' diag(is) Knm,    b = Knm' (is y)
    l  = -1/2 (log|B| - log|Kj| + sum log s + n log 2 pi)
         - 1/2 (y' diag(is) y - b' B^-1 b)
         [variational: - 1/2 sum(is r)]
    means  = K*m B^-1 b
    var    = k** - rowsq(K*m L^-T) + rowsq(K*m LB^-T),   LB = chol(B)

The jitter is the model's: in f32 the program raises the configured jitter
to 1e-5 of K(Z, Z)'s mean diagonal (a differentiable quantity), and the
reference takes the same rule whatever precision it computes in.

B is factored whitened, B = L (I + G) L' with G = V' diag(is) V and V =
Knm L^-T, so that the factor exists in float32 too; squared distances are
taken elementwise (no GEMM expansion).  Rows stream in blocks
under ``torch.utils.checkpoint``, so memory is a few blocks whatever n is;
the gradient is autograd's.

``precision``: "f64" is the reference; "f32" computes in float32; "tf32"
in float32 with the operands of every matrix product rounded to TF32 (10
mantissa bits, round to nearest even), what a tensor-core product does:
the lower-precision control.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

LOG_2PI = math.log(2.0 * math.pi)
DTYPES = {"f64": torch.float64, "f32": torch.float32, "tf32": torch.float32}


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to TF32's 10 mantissa bits, nearest even."""
    i = t.contiguous().view(torch.int32).to(torch.int64)
    r = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    r = torch.where(r > 0x7FFFFFFF, r - (1 << 32), r)
    r = torch.where(r < -(1 << 31), r + (1 << 32), r)
    return r.to(torch.int32).view(torch.float32)


class _TF32MM(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, in the backward's two
    products as in the forward's."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return torch.matmul(g, b.mT), torch.matmul(a.mT, g)


class Precision:
    def __init__(self, name: str):
        if name not in DTYPES:
            raise ValueError(f"precision {name!r}; valid: {sorted(DTYPES)}")
        self.name = name
        self.dtype = DTYPES[name]

    def mm(self, a, b):
        if self.name == "tf32":
            return _TF32MM.apply(a, b)
        return torch.matmul(a, b)


class no_tf32:
    """Full-precision products inside, whatever the process had set."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


# ------------------------------------------------------------ hyper layout

def unpack(cfg: dict, x: torch.Tensor) -> dict:
    """The packed vector's fields (the program's documented layout,
    ``optim/pack.py``): log sigma2, the family's hyper fields in sorted
    name order, then z row-major."""
    m, dz = cfg["m"], cfg.get("d_proj", cfg["d"])
    shapes = {"log_ell": (), "log_sf2": (), "log_hetero_skedasticity": (m,),
              "log_multiscales_m05": (m, dz), "tproj": (cfg["d"], dz)}
    hp = {"sigma2": torch.exp(x[0])}
    at = 1
    for name in cfg["packed_fields"]:
        k = math.prod(shapes[name])
        hp[name] = x[at:at + k].reshape(shapes[name])
        at += k
    hp["z"] = x[at:].reshape(m, dz)
    if at + m * dz != x.shape[0]:
        raise ValueError(f"packed vector of {x.shape[0]}, layout wants "
                         f"{at + m * dz}")
    return hp


# ------------------------------------------------------------ covariances

def _multiscales(hp):
    return torch.exp(hp["log_multiscales_m05"]) + 0.5


def k_cross(family, hp, X, prec: Precision):
    """K(X, Z), (b, m)."""
    z = hp["z"]
    if family == "se_iso":
        d2 = torch.sum(torch.square(X[:, None, :] - z[None, :, :]), dim=-1)
        return torch.exp(hp["log_sf2"] - 0.5 * torch.exp(-2.0 * hp["log_ell"])
                         * d2)
    if family == "se_fat":
        p = prec.mm(X, hp["tproj"])
        u = _multiscales(hp)
        quad = torch.sum(torch.square(p[:, None, :] - z[None, :, :])
                         / u[None] + torch.log(u)[None], dim=-1)
        return torch.exp(hp["log_sf2"] - 0.5 * quad)
    raise ValueError(family)


def k_upper(family, hp):
    """K(Z, Z), (m, m), with the family's diagonal."""
    z = hp["z"]
    if family == "se_iso":
        d2 = torch.sum(torch.square(z[:, None, :] - z[None, :, :]), dim=-1)
        return torch.exp(hp["log_sf2"] - 0.5 * torch.exp(-2.0 * hp["log_ell"])
                         * d2)
    if family == "se_fat":
        u = _multiscales(hp)
        s = u[:, None, :] + u[None, :, :] - 1.0
        quad = torch.sum(torch.square(z[:, None, :] - z[None, :, :]) / s
                         + torch.log(s), dim=-1)
        k = torch.exp(hp["log_sf2"] - 0.5 * quad)
        return k + torch.diag(torch.exp(hp["log_hetero_skedasticity"]))
    raise ValueError(family)


def k_diag(family, hp, n, like):
    return torch.exp(hp["log_sf2"]).to(like.dtype).expand(n)


def jittered(cfg, km):
    """K(Z, Z) + jitter I with the model's jitter rule (module
    docstring)."""
    jit = cfg["jitter"]
    if cfg["dtype"] == "float32":
        jit = torch.clamp(cfg["jitter_f32_rel"]
                          * torch.mean(torch.abs(torch.diagonal(km))),
                          min=cfg["jitter"])
    return km + jit * torch.eye(km.shape[0], dtype=km.dtype,
                                device=km.device)


# ------------------------------------------------------------ the evidence

def _block(family, names, prec, Xb, yb, linv, *leaves):
    """One row block's share of (G, u, sum log s, y' is y, sum is r), with
    V = Knm L^-T, G = V' diag(is) V and u = V' (is y)."""
    hp = dict(zip(names, leaves))
    knm = k_cross(family, hp, Xb, prec)
    v = prec.mm(knm, linv.T)
    r = k_diag(family, hp, Xb.shape[0], knm) - torch.sum(v * v, dim=1)
    s = r + hp["sigma2"]
    isv = 1.0 / s
    a = v * torch.sqrt(isv)[:, None]
    return (prec.mm(a.T, a), prec.mm(v.T, (isv * yb)[:, None])[:, 0],
            torch.sum(torch.log(s)), torch.sum(isv * yb * yb),
            torch.sum(isv * r))


def _chol(a):
    """Lower Cholesky factor; NaN where ``a`` is not positive definite."""
    lo, info = torch.linalg.cholesky_ex(a)
    return torch.where(info != 0, torch.full_like(lo, float("nan")), lo)


def _inducing(cfg, hp, dt, dev):
    """(L, L^-1) of K(Z, Z) + jitter I."""
    lk = _chol(jittered(cfg, k_upper(cfg["family"], hp)))
    eye = torch.eye(lk.shape[0], dtype=dt, device=dev)
    return lk, torch.linalg.solve_triangular(lk, eye, upper=False)


def _stats(cfg, hp, prec, X, y, linv, block, checkpointed):
    names = list(hp)
    leaves = [hp[k] for k in names]
    acc = None
    for i in range(0, X.shape[0], block):
        args = (cfg["family"], names, prec, X[i:i + block].to(prec.dtype),
                y[i:i + block].to(prec.dtype), linv, *leaves)
        part = (checkpoint(_block, *args, use_reentrant=False)
                if checkpointed else _block(*args))
        acc = part if acc is None else tuple(
            a + p for a, p in zip(acc, part))
    return acc


def neg_mean_evidence(cfg: dict, x, X, y, *, precision: str = "f64",
                      block: int = 8192, grad: bool = True):
    """(-l / n, its gradient in x) at the packed vector ``x``; the rows
    (X, y) in any dtype, cast block by block.  log|B| - log|Kj| is
    log|I + G| and b' B^-1 b is |LG^-1 u|^2 with LG the factor of I + G."""
    prec = Precision(precision)
    dt = prec.dtype
    dev = X.device
    with no_tf32(), torch.enable_grad():
        xv = x.detach().to(device=dev, dtype=dt).requires_grad_(grad)
        hp = unpack(cfg, xv)
        _, linv = _inducing(cfg, hp, dt, dev)
        gram, u, log_s, y_is_y, is_r = _stats(cfg, hp, prec, X, y, linv,
                                              block, grad)
        eye = torch.eye(gram.shape[0], dtype=dt, device=dev)
        lg = _chol(eye + gram)
        w = torch.linalg.solve_triangular(lg, u[:, None], upper=False)
        n = X.shape[0]
        l1 = -0.5 * (2.0 * torch.sum(torch.log(torch.diagonal(lg)))
                     + log_s + n * LOG_2PI)
        if cfg["variational"]:
            l1 = l1 - 0.5 * is_r
        l2 = -0.5 * (y_is_y - torch.sum(w * w))
        f = -(l1 + l2) / n
        if not grad:
            return f.detach(), None
        (g,) = torch.autograd.grad(f, xv)
    return f.detach(), g.detach()


# ------------------------------------------------------------ serving

@torch.no_grad()
def condition(cfg: dict, x, X, y, *, precision: str = "f64",
              block: int = 8192) -> dict:
    """The conditioned posterior at the packed vector ``x``: the hypers,
    L^-1, the factor's inverse LG^-1 of I + G, and the mean coefficients
    B^-1 b = L^-T (I + G)^-1 u."""
    prec = Precision(precision)
    dt = prec.dtype
    dev = X.device
    with no_tf32():
        hp = unpack(cfg, x.to(device=dev, dtype=dt))
        _, linv = _inducing(cfg, hp, dt, dev)
        gram, u = _stats(cfg, hp, prec, X, y, linv, block, False)[:2]
        eye = torch.eye(gram.shape[0], dtype=dt, device=dev)
        lginv = torch.linalg.solve_triangular(_chol(eye + gram), eye,
                                              upper=False)
        t = prec.mm(lginv.T, prec.mm(lginv, u[:, None]))
        coeffs = prec.mm(linv.T, t)[:, 0]
    return {"hp": hp, "linv": linv, "lginv": lginv, "coeffs": coeffs,
            "prec": prec, "family": cfg["family"]}


@torch.no_grad()
def predict(post: dict, Xt, *, block: int = 8192):
    """(means, variances without the noise) at the rows Xt:
    k** - |L^-1 k*|^2 + |LG^-1 L^-1 k*|^2."""
    prec = post["prec"]
    dt = prec.dtype
    means, variances = [], []
    with no_tf32():
        for i in range(0, Xt.shape[0], block):
            xb = Xt[i:i + block].to(dt)
            ktm = k_cross(post["family"], post["hp"], xb, prec)
            means.append(prec.mm(ktm, post["coeffs"][:, None])[:, 0])
            q = prec.mm(ktm, post["linv"].T)
            w = prec.mm(q, post["lginv"].T)
            variances.append(k_diag(post["family"], post["hp"], xb.shape[0],
                                    ktm) - torch.sum(q * q, dim=1)
                             + torch.sum(w * w, dim=1))
    return torch.cat(means), torch.cat(variances)
