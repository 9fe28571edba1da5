"""bayesgp_torch stands alone: it imports neither jax nor the JAX
package, and its entry points refuse a missing card instead of falling
back to the CPU."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bayesgp_torch as tbg

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|bayesgp_tpu)\b|from\s+(jax|bayesgp_tpu)\b)",
    re.MULTILINE)


def test_import_pulls_in_no_jax():
    code = ("import sys, bayesgp_torch, bayesgp_torch.convert, "
            "bayesgp_torch.parallel.replicates, bayesgp_torch.fast.batched, "
            "bayesgp_torch.linalg.band_batched, "
            "bayesgp_torch.linalg.band_arrow_batched, "
            "bayesgp_torch.fast.scatter_iid, bayesgp_torch.linalg.chol_dense, "
            "bayesgp_torch.fast.banded, bayesgp_torch.datasets, "
            "bayesgp_torch.model.objective, bayesgp_torch.inference.laplace, "
            "bayesgp_torch.serialize, bayesgp_torch.model.families, "
            "bayesgp_torch.model.build, bayesgp_torch.api, "
            "bayesgp_torch.inference.aghq, bayesgp_torch.postfit; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'bayesgp_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_no_source_imports_jax():
    files = sorted((ROOT / "bayesgp_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.linspace(0, 10, 50)
    data = {"x": x, "y": np.ones(50), "z": np.zeros(50)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbg.model_fit("y ~ z + f(x, model='IWP', order=3, k=10)",
                      data=data, family="Poisson", engine="banded",
                      device="cuda")
