"""Guard tests for the PyTorch port's boundaries.

`mvsformer_torch` imports torch, never JAX, flax or the JAX package (not
even its JAX-free modules), nor Triton, nor an image library (OpenCV, PIL,
torchvision: the machine with the card has none, so the port keeps its own
codecs), nor orbax or TensorBoard (its checkpoints are `torch.save` files,
its scalars go to the log and a JSON-lines file), and neither does
`chip_smoke.py`. Its entry
points run on CUDA unless the caller asks for the CPU, and raise when CUDA
is asked for and absent.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.config import ViTConfig as JaxViTConfig
from mvsformer_tpu.config import load_config as jax_load_config
from mvsformer_torch.config import ModelConfig, ViTConfig, load_config
from mvsformer_torch.models.mvsformer import TwinMVSNet, build_model
from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.stage_tail import depth_decode

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mvsformer_tpu")
IMAGE_LIBRARIES = ("cv2", "PIL", "torchvision")
# The test pipeline's modules (save_depth, the eval data, fusion, the CLI),
# each beside its JAX counterpart's name.
PIPELINE_MODULES = ("utils.pfm", "utils.cams", "utils.ply", "utils.image", "data.augment",
                    "data.scan_lists", "data.eval_dataset", "data.loader", "utils.metrics",
                    "ops.fusion", "utils.convert_weights", "infer", "fuse", "test")
# The training run's modules (the data layer, the loader, checkpoints, the
# trainer and its command line).
TRAINING_MODULES = ("config", "data.dtu", "data.blended", "data.loader", "train.meters",
                    "train.checkpoint", "train.optim", "train.step", "train.trainer",
                    "train.__main__", "utils.logging")
TRAINING_LIBRARIES = ("orbax", "tensorboardX", "tensorboard", "torch.utils.tensorboard")
# The process grid's modules (data and view parallelism, the dry run).
PARALLEL_MODULES = ("parallel.mesh", "parallel.dryrun")


def port_files():
    root = os.path.join(REPO, "mvsformer_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mvsformer_torch\n"
        "for m in pkgutil.walk_packages(mvsformer_torch.__path__, 'mvsformer_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len([m for m in sys.modules if m.startswith('mvsformer_torch.')]))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20  # every module of the package was imported


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_file_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_file_imports_triton(path):
    """Every kernel is CUDA C++ built by nvcc and bound by ctypes, so the
    card's machine needs no Triton."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert not [n for n in names if n.split(".")[0] == "triton"], f"{path} imports triton"


def imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    return names + [node.module or "" for node in ast.walk(tree)
                    if isinstance(node, ast.ImportFrom) and node.level == 0]


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_file_imports_an_image_library(path):
    bad = [n for n in imported_names(path) if n.split(".")[0] in IMAGE_LIBRARIES]
    assert not bad, f"{path} imports {bad}"


def test_the_pipeline_modules_are_among_the_port_files():
    files = set(port_files())
    for name in PIPELINE_MODULES + TRAINING_MODULES + PARALLEL_MODULES:
        path = os.path.join(REPO, "mvsformer_torch", *name.split(".")) + ".py"
        assert path in files, name


def library_of(name, libraries):
    """The entry of `libraries` that module `name` is, or is inside of."""
    return next((lib for lib in libraries if name == lib or name.startswith(lib + ".")), None)


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_file_imports_orbax_or_tensorboard(path):
    bad = [n for n in imported_names(path) if library_of(n, TRAINING_LIBRARIES)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_pipeline_leaves_image_libraries_out_of_sys_modules():
    code = (
        "import importlib, sys\n"
        f"for m in {PIPELINE_MODULES + TRAINING_MODULES + PARALLEL_MODULES!r}:\n"
        "    importlib.import_module('mvsformer_torch.' + m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {IMAGE_LIBRARIES + FORBIDDEN!r}\n"
        f"       or any(m == t or m.startswith(t + '.') for t in {TRAINING_LIBRARIES!r})]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_build_model_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(ndepths=[8, 4, 4, 2])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, device="cuda")


def tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("raises", [False, True])
def test_forward_runs_with_tf32_off_and_restores_the_flags(monkeypatch, raises):
    """The fp32 model's forward, the one that is timed and checked, runs its
    convolutions and matmuls in full fp32 whatever the caller set."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []

    class Probe:
        def _forward(self, *args):
            seen.append(tf32_flags())
            if raises:
                raise ValueError("in the forward")
            return "out"

    if raises:
        with pytest.raises(ValueError):
            TwinMVSNet.forward(Probe(), None, None, None)
    else:
        assert TwinMVSNet.forward(Probe(), None, None, None) == "out"
    assert seen == [(False, False)]
    assert tf32_flags() == (True, True)


def test_build_model_rejects_what_later_slices_port():
    with pytest.raises(NotImplementedError, match=r"multi_scale \(ROADMAP A6\)"):
        build_model(ModelConfig(multi_scale=True), device="cpu")


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    before = dict(cuda_build.LAUNCHES)
    logits = torch.zeros((1, 4, 3, 5))
    dv = torch.ones((1, 4, 3, 5))
    depth, conf = depth_decode(logits, dv, 5.0)
    assert torch.allclose(depth, torch.ones(1, 3, 5))
    assert torch.allclose(conf, torch.full((1, 3, 5), 0.25))
    assert dict(cuda_build.LAUNCHES) == before


@pytest.mark.parametrize("name", ["config_mvsformer.json", "config_mvsformer-p.json",
                                  "config_mvsformer_blendmvs.json"])
def test_load_config_reads_the_repo_configs_like_the_jax_package(name):
    path = os.path.join(REPO, "configs", name)
    port, ref = load_config(path).arch, jax_load_config(path).arch
    for f in dataclasses.fields(ModelConfig):
        if f.name == "vit_args":
            continue
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    for f in dataclasses.fields(ViTConfig):
        assert getattr(port.vit_args, f.name) == getattr(ref.vit_args, f.name), f.name
    assert set(f.name for f in dataclasses.fields(ModelConfig)) < set(
        f.name for f in dataclasses.fields(JaxModelConfig))
    assert set(f.name for f in dataclasses.fields(ViTConfig)) <= set(
        f.name for f in dataclasses.fields(JaxViTConfig))


def test_importing_the_parallel_modules_starts_no_process_group():
    """`mvsformer_torch.parallel` joins no group and spawns no process when
    it is imported: the CLIs and the dry run do that when they run."""
    code = ("import torch.distributed as dist\n"
            "import mvsformer_torch.parallel.mesh, mvsformer_torch.parallel.dryrun\n"
            "import multiprocessing as mp\n"
            "assert not dist.is_initialized() and not mp.active_children()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
