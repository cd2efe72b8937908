"""The port stands alone: no JAX, no tpugnn, and CUDA by default."""

import ast
import os

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tpugnn"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tpugnn_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_jax_or_tpugnn_imports():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_asked_for_cpu(no_cuda):
    from tpugnn_torch.eval import ler_monte_carlo
    from tpugnn_torch.models.convert import load_decoder
    from tpugnn_torch.serve import DecodeEngine
    from tpugnn_torch.tanner import build_code
    from tpugnn_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_decoder()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine.from_npz()
    cfg, model, graph = load_decoder(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ler_monte_carlo(model, build_code("surface", 3), p=0.1, shots=1, batch=1,
                        generator=torch.Generator())
    assert resolve_device("cpu").type == "cpu"


def test_train_needs_cuda_unless_asked_for_cpu(no_cuda, tmp_path):
    """train() defaults to the card and raises without one, before it
    builds, samples or writes anything."""
    from tpugnn_torch.configs import ExperimentConfig, TrainConfig
    from tpugnn_torch.train import train

    cfg = ExperimentConfig(train=TrainConfig(steps=1, checkpoint_dir=str(tmp_path / "c")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg)
    assert not (tmp_path / "c").exists()


def test_smoke_refuses_without_cuda(no_cuda, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_build_is_lazy():
    """Importing the kernel and training modules builds and loads nothing."""
    import tpugnn_torch.kernels.fused_backward  # noqa: F401
    import tpugnn_torch.train  # noqa: F401
    from tpugnn_torch.kernels import _build

    assert _build.load_library.cache_info().currsize == 0
    assert set(_build.SOURCES) == {"fused_rounds", "fused_backward"}
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
