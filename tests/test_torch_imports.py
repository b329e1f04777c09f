"""The port stands alone: importing it loads neither JAX nor the JAX
package, and its entry points do not fall back to the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from normalizingflow_tpu_torch import bench, bench_scaling
from normalizingflow_tpu_torch.apps.sample_data import generate
from normalizingflow_tpu_torch.config import (
    Config,
    config_device,
    setup_model,
)
from normalizingflow_tpu_torch.mcmc import (
    collect_hmc_data,
    flow_smc,
    neutra_hmc,
    run_hmc,
    run_nuts,
    run_smc,
)
from normalizingflow_tpu_torch.targets import NealsFunnel
from normalizingflow_tpu_torch.train.fused import train_flow_fused
from normalizingflow_tpu_torch.train.loop import train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
import normalizingflow_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "normalizingflow_tpu", "bench",
                                    "bench_scaling", "tools"))
need = {pkg.__name__ + "." + m for m in (
    "targets.eam", "targets.phi4", "targets.gff", "apps.polymer",
    "mcmc.nuts", "mcmc.smc", "parallel.mesh", "parallel.sharded",
    "utils.profiling", "utils.mfu", "bench", "bench_scaling")}
print(len(names), sorted(need - set(names)), bad)
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, missing, bad = out.stdout.strip().split(" ", 2)
    assert missing == "[]", missing
    assert bad == "[]", bad
    assert int(count) >= 20  # every submodule was imported


IMPORT_PARITY_TOOL = """
import sys
import tools.torch_parity
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "normalizingflow_tpu", "chip_smoke")
             or m == "tools.parity")
print(bad)
"""


def test_parity_tool_imports_no_jax():
    """tools/torch_parity.py, which chip_smoke.py imports, loads neither
    JAX nor the JAX package nor its twin tools/parity.py, and not
    chip_smoke; its source names none of them."""
    out = subprocess.run([sys.executable, "-c", IMPORT_PARITY_TOOL],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    src = (ROOT / "tools" / "torch_parity.py").read_text()
    assert "normalizingflow_tpu." not in src.replace(
        "normalizingflow_tpu_torch", "")
    for name in ("jax", "flax", "optax", "chip_smoke", "tools.parity",
                 "tools import parity"):
        assert f"import {name}" not in src and f"from {name}" not in src


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "normalizingflow_tpu." not in src \
        .replace("normalizingflow_tpu_torch", "")
    for name in ("flax", "optax", "jax_resume_fixture"):
        assert f"import {name}" not in src and f"from {name}" not in src


def test_entry_points_default_to_cuda_and_do_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_hmc(gen, lambda x: -0.5 * (x * x).sum(-1), torch.zeros(4, 2), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        neutra_hmc(gen, torch.nn.Linear(2, 2), NealsFunnel(2), 4, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_nuts(gen, lambda x: -0.5 * (x * x).sum(-1), torch.zeros(4, 2),
                 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_smc(gen, torch.zeros(4, 2), NealsFunnel(2).log_prob,
                NealsFunnel(2).log_prob)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(torch.nn.Linear(2, 2), NealsFunnel(2), 1, 4, gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_flow_fused(torch.nn.Linear(2, 2), gen, NealsFunnel(2))
    flow = torch.nn.Linear(2, 2)
    flow.sample = lambda n, generator=None, z=None: (torch.zeros(n, 2),) * 3
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collect_hmc_data(flow, NealsFunnel(2), n_chains=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flow_smc(gen, flow, NealsFunnel(2), 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_scaling.main()


@pytest.mark.parametrize("device", ["tpu", "cuda", "cuda:1", None])
def test_configs_run_on_the_card_unless_they_say_cpu(device):
    """A config's `device:` key: cpu is the CPU; tpu, cuda, cuda:N or no
    key mean the card, which raises here instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    cfg = Config(device=device)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config_device(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        setup_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(cfg, nframes=4, chains=2)
    assert config_device(Config(device="cpu")) == torch.device("cpu")


def test_entry_points_refuse_tensors_on_another_device():
    with pytest.raises(ValueError, match="expected"):
        run_hmc(torch.Generator(), lambda x: -0.5 * (x * x).sum(-1),
                torch.zeros(4, 2, device="meta"), 2, device="cpu")


def test_nuts_and_smc_refuse_tensors_on_another_device():
    with pytest.raises(ValueError, match="expected"):
        run_nuts(torch.Generator(), lambda x: -0.5 * (x * x).sum(-1),
                 torch.zeros(4, 2, device="meta"), 2, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        run_smc(torch.Generator(), torch.zeros(4, 2, device="meta"),
                NealsFunnel(2).log_prob, NealsFunnel(2).log_prob,
                device="cpu")
