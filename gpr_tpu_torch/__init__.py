"""gpr_tpu_torch -- the PyTorch/CUDA port of gpr_tpu.

Sparse (FITC) Gaussian process regression on an NVIDIA GPU.  The package
keeps ``gpr_tpu``'s module layout and function names; the kernels that
``gpr_tpu`` wrote in Pallas for the TPU are hand-written CUDA here
(``csrc/``, built at first use), each beside a plain PyTorch twin that CPU
tensors run.  Ported so far: the SE-iso streaming conditioning and serving
path (``models.streaming``), its training step (the hand VJP of
``models.stream_grad`` and the L-BFGS ``optim.fit``), the dense engine
(``models.fitc``) with the inducing choosers, multi-start training with
f64 rescoring and the f64 polish (``optim.fit_restarts``,
``optim.polish``), the README's Quick-start path (the host ``optim.train``
with checkpoint and resume in ``io.resume``, ``optim.train_sgd`` and
``optim.train_smd``, dense serving in ``models.predict``, ``models.stats``
and ``models.sample``, the FITC LOO of ``models.loo``, ``datasets``), the
flagship se_fat family and every other base family (``kernels``, through
the plain streaming loop), per-row noise on the streaming path, the
command-line trainer/predictor (``cli``, with its CSV parser binding
``io.native``), the roofline GEMM chain (``ops.gemm_chain``), the
block-diagonal numerics (``numerics.block_diag``), the npz model
artifacts (``io``), the Gaussian-likelihood extensions, the Laplace
likelihoods, EP and the softmax Laplace, the iterative exact GP
(``models.iterative``), the HMC hyper posterior (``optim.hmc``) and the
tooling modules ``testing``, ``utils`` and ``viz``.
"""

__version__ = "0.1.0"

from . import datasets, io, kernels, models, numerics, ops, optim
from .config import config

__all__ = ["datasets", "io", "kernels", "models", "numerics", "ops", "optim",
           "config", "__version__"]
