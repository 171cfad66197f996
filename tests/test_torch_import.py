"""gpr_tpu_torch never imports JAX: neither in its source nor at run time."""

import ast
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "gpr_tpu_torch"
# modules of the training leg, the roofline path, the Quick-start path, the
# command-line path, the base kernel families, the Gaussian-likelihood
# extensions, the Laplace likelihoods, EP and the softmax Laplace, the
# iterative exact GP, HMC and the tooling, named so that a move or a rename
# cannot drop them from the scan unnoticed
NEWER = ("models/fitc.py", "optim/lbfgs.py", "optim/train.py",
         "optim/polish.py", "ops/gemm_chain.py", "datasets.py",
         "models/predict.py", "models/stats.py", "models/sample.py",
         "models/loo.py", "optim/sgd_smd.py", "io/resume.py", "cli.py",
         "io/native.py", "kernels/se_fat.py", "kernels/se_ard.py",
         "kernels/matern.py", "kernels/rq.py", "kernels/periodic.py",
         "kernels/cosine.py", "kernels/lin_one.py", "kernels/lin_ard.py",
         "kernels/const.py", "numerics/block_diag.py", "models/robust.py",
         "models/warped.py", "models/pitc.py", "models/online.py",
         "models/exact.py", "models/multitask.py", "models/ift.py",
         "models/classify.py", "models/classify_stream.py",
         "models/poisson.py", "models/binomial.py", "models/negbin.py",
         "models/ordinal.py", "models/classify_ep.py",
         "models/classify_multi.py", "models/classify_multi_stream.py",
         "models/iterative.py", "optim/hmc.py", "testing.py", "utils.py",
         "viz.py", "parallel/spmd.py", "parallel/sharded.py",
         "parallel/classify_sharded.py", "parallel/iter_sharded.py")


def _jax_imports(path):
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        found += [n for n in names if n == "jax" or n.startswith("jax.")
                  or n == "gpr_tpu" or n.startswith("gpr_tpu.")]
    return found


def test_source_has_no_jax_import():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    assert {PKG / f for f in NEWER} <= set(files)
    bad = {str(f.relative_to(PKG)): _jax_imports(f) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_import_loads_no_jax():
    """Compare sys.modules before and after the import: a site hook may
    preload modules into a fresh interpreter."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import gpr_tpu_torch, gpr_tpu_torch.convert\n"
        "import gpr_tpu_torch.optim.polish, gpr_tpu_torch.optim.train\n"
        "import gpr_tpu_torch.ops.gemm_chain, gpr_tpu_torch.io.resume\n"
        "from gpr_tpu_torch.kernels import SeIso\n"
        "from gpr_tpu_torch.optim import train, train_sgd, train_smd\n"
        "from gpr_tpu_torch.models import (calc_stats, mean_predictor, "
        "co_variance_predictor, predict_means, predict_variances, "
        "cov_sample, loo_objective_fitc)\n"
        "from gpr_tpu_torch.datasets import gen_data\n"
        "import gpr_tpu_torch.cli, gpr_tpu_torch.io.native\n"
        "from gpr_tpu_torch.kernels.se_fat import SeFat\n"
        "from gpr_tpu_torch.kernels import (Const, Cosine, LinArd, LinOne, "
        "Matern32, Matern52, Periodic, RatQuad, SeArd, weighted_eval, "
        "weighted_eval_one, choose_subset)\n"
        "import gpr_tpu_torch.kernels.se_ard, gpr_tpu_torch.kernels.matern\n"
        "import gpr_tpu_torch.kernels.rq, gpr_tpu_torch.kernels.periodic\n"
        "import gpr_tpu_torch.kernels.cosine, gpr_tpu_torch.kernels.const\n"
        "import gpr_tpu_torch.kernels.lin_one, gpr_tpu_torch.kernels.lin_ard\n"
        "from gpr_tpu_torch.numerics import block_diag, tsqr_r\n"
        "from gpr_tpu_torch.models import (fit_t, fit_warped, "
        "pitc_log_evidence, online_update, fit_exact, multi_start)\n"
        "from gpr_tpu_torch.convert import warp_from_jax\n"
        "from gpr_tpu_torch.models.classify import classify_log_evidence\n"
        "from gpr_tpu_torch.models.ordinal import fit_ordinal\n"
        "from gpr_tpu_torch.models import (fit_classify, fit_poisson, "
        "fit_binomial, fit_negbin, stream_classify_log_evidence)\n"
        "from gpr_tpu_torch.optim import extend_pack\n"
        "from gpr_tpu_torch.models import (ep_log_evidence, ep_predict, "
        "fit_classify_ep, multiclass_log_evidence, multiclass_predict, "
        "fit_classify_multi, stream_multiclass_log_evidence, "
        "stream_multiclass_predict, stream_multiclass_state)\n"
        "from gpr_tpu_torch.models import (iter_trained, fit_iter, "
        "evidence_grads_iter, predict_variances_iter)\n"
        "from gpr_tpu_torch.optim import (hmc, sample_posterior, "
        "predict_hmc_mixture)\n"
        "import gpr_tpu_torch.testing, gpr_tpu_torch.utils, "
        "gpr_tpu_torch.viz\n"
        "from gpr_tpu_torch.parallel import (run_spmd, fit_sharded, "
        "sharded_classify_log_evidence, sharded_iter_solve)\n"
        "assert 'matplotlib' not in sys.modules or 'matplotlib' in before\n"
        "assert gpr_tpu_torch.io.native.get_lib() is not None\n"
        "new = sorted(set(sys.modules) - before)\n"
        "bad = [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', "
        "'gpr_tpu')]\n"
        "print(len(new), bad)\n"
        "sys.exit(1 if bad or not any(m.startswith('gpr_tpu_torch.ops') "
        "for m in new) else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
