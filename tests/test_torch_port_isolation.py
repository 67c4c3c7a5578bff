"""The port stands alone: no file of ``paddle_tpu_torch/`` and not
``chip_smoke.py`` imports ``jax`` or ``paddle_tpu`` (checked on the
source and by importing the package in a fresh interpreter), and its
entry points never fall back to the CPU quietly when no GPU is found."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_in_fresh_interpreter_loads_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch\n"
            "import paddle_tpu_torch.inference.factory\n"
            "import paddle_tpu_torch.inference.decode_engine\n"
            "import paddle_tpu_torch.models.convert\n"
            "import paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.ops.fused_ce\n"
            "import paddle_tpu_torch.ops.flash_attention\n"
            "import paddle_tpu_torch.ops.decode_attention\n"
            "import paddle_tpu_torch.ops.decode_megakernel\n"
            "import paddle_tpu_torch.ops.quant_matmul\n"
            "import paddle_tpu_torch.quantization\n"
            "import paddle_tpu_torch.ops.layer_norm\n"
            "import paddle_tpu_torch.nn\n"
            "import paddle_tpu_torch.nn.functional.common\n"
            "import paddle_tpu_torch.incubate.nn\n"
            "import paddle_tpu_torch.incubate.nn.functional\n"
            "import paddle_tpu_torch.incubate.moe\n"
            "import paddle_tpu_torch.observability\n"
            "import paddle_tpu_torch.observability.devprof\n"
            "import paddle_tpu_torch.ops.launch_probe\n"
            "import paddle_tpu_torch.testing.faults\n"
            "import paddle_tpu_torch.tools.profile_decode\n"
            "import paddle_tpu_torch.serving\n"
            "import paddle_tpu_torch.serving.kv_transfer\n"
            "import paddle_tpu_torch.serving.disagg\n"
            "import paddle_tpu_torch.native\n"
            "import paddle_tpu_torch.distributed.resilience\n"
            "import paddle_tpu_torch.distributed.liveness\n"
            "import paddle_tpu_torch.distributed.membership\n"
            "import paddle_tpu_torch.serving.router\n"
            "import paddle_tpu_torch.observability.fleet\n"
            "import threading\n"
            "assert threading.active_count() == 1, 'import started a thread'\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; a GPU is present")
    from paddle_tpu_torch.inference.factory import make_engine
    from paddle_tpu_torch.models import gpt
    cfg = gpt.gpt_tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt.GPT(cfg)
    model = gpt.GPT(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(model, n_pages=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_engine(model, n_pages=4, device="cuda")
    for kw in ({}, {"weight_dtype": "int8"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_engine(model, engine="contiguous", **kw)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No compiler, no kernels: the build raises instead of letting a
    caller fall back to a plain version."""
    from paddle_tpu_torch.ops import _build
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("checks the no-compiler behaviour; nvcc is present")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert sorted(_build.sources()) == ["decode_attention",
                                        "decode_megakernel",
                                        "flash_attention_bwd",
                                        "flash_attention_fwd", "fused_ce",
                                        "fused_ce_bwd", "launch_probe",
                                        "layer_norm", "paged_attention",
                                        "quant_matmul"]
