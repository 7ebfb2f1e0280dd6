"""Boundaries of the PyTorch port: importing ``repro_torch`` (every
submodule, the pipeline slice's, the schedule lint's, the SPMD
runner's, the checkpoints', the resilience runtime's, the dense
family's and the MoE, hybrid, xLSTM and Whisper families' among them) and
``chip_smoke.py`` loads neither ``jax`` nor ``repro`` nor ``networkx``
nor ``msgpack`` nor ``ml_dtypes``,
checked in a fresh interpreter because the test worker may already hold
jax; the port's sources call no library attention or compiler; and
``chip_smoke.py`` refuses to run where there is no card."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_GUARD = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "networkx",
                                    "msgpack", "ml_dtypes"))
print(" ".join(names))
assert not bad, bad
"""

#: the pipeline slice's, schedlint's and the SPMD runner's modules, which
#: must be among those imported
PIPELINE_MODULES = (
    "repro_torch.core.schedule", "repro_torch.core.schedule.graph",
    "repro_torch.core.schedule.schedulers",
    "repro_torch.core.schedule.simulator",
    "repro_torch.core.schedule.memory", "repro_torch.core.pipeline",
    "repro_torch.core.modality", "repro_torch.core.modality_parallel",
    "repro_torch.parallel.plan", "repro_torch.parallel.api",
    "repro_torch.models.stages", "repro_torch.launch",
    "repro_torch.launch.train", "repro_torch.analysis",
    "repro_torch.analysis.findings", "repro_torch.analysis.schedlint",
    "repro_torch.parallel.spmd")

#: the runtime's modules (checkpoints, resilience), likewise
RUNTIME_MODULES = (
    "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
    "repro_torch.checkpoint._msgpack", "repro_torch.resilience",
    "repro_torch.resilience.faults", "repro_torch.resilience.monitor",
    "repro_torch.resilience.manager", "repro_torch.resilience.trainer")

#: the dense-family remainder's modules (the vlm backbone, the configs)
DENSE_MODULES = (
    "repro_torch.models.vlm", "repro_torch.configs.gemma2_9b",
    "repro_torch.configs.qwen2_5_14b", "repro_torch.configs.starcoder2_7b",
    "repro_torch.configs.qwen2_vl_7b")

#: the MoE, hybrid, xLSTM and Whisper families' modules (models and
#: configs)
FAMILY_MODULES = (
    "repro_torch.models.moe", "repro_torch.models.mamba2",
    "repro_torch.configs.deepseek_moe_16b",
    "repro_torch.configs.qwen2_moe_a2_7b", "repro_torch.configs.zamba2_2_7b",
    "repro_torch.models.xlstm", "repro_torch.models.whisper",
    "repro_torch.configs.xlstm_125m", "repro_torch.configs.whisper_base")


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_neither_jax_nor_repro():
    code = _GUARD.format(src=str(ROOT / "src"), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr
    names = res.stdout.split()
    assert len(names) >= 62
    want = set(PIPELINE_MODULES) | set(RUNTIME_MODULES) | \
        set(DENSE_MODULES) | set(FAMILY_MODULES)
    assert want <= set(names), sorted(want - set(names))


def test_port_sources_call_no_library_attention():
    banned = ("scaled_dot_product_attention", "torch.compile",
              "flex_attention", "cudnn", "flash_attn", "import jax",
              "from jax", "from repro.", "import repro\n",
              "import networkx", "from networkx", "import msgpack",
              "from msgpack", "import ml_dtypes", "from ml_dtypes")
    for path in PORT.rglob("*"):
        if path.suffix not in (".py", ".cu", ".cuh"):
            continue
        text = path.read_text()
        for word in banned:
            assert word not in text, f"{path.relative_to(ROOT)}: {word}"


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=_env(), cwd=str(ROOT))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
