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
    import tpugnn_torch.kernels.roll_gather  # noqa: F401
    import tpugnn_torch.kernels.sddmm  # noqa: F401
    import tpugnn_torch.kernels.spmm  # noqa: F401
    import tpugnn_torch.models.pallas_decoder  # noqa: F401
    import tpugnn_torch.mp  # noqa: F401
    import tpugnn_torch.train  # noqa: F401
    from tpugnn_torch.kernels import _build

    assert _build.load_library.cache_info().currsize == 0
    assert set(_build.SOURCES) == {"fused_rounds", "fused_backward", "spmm", "sddmm",
                                  "roll_gather"}
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("script", ["_probe_common.py", "k2b_probe.py", "k4_probe.py",
                                    "k5_probe.py", "smoke_turns.py", "ler_rows_card.py"])
def test_kernel_probes_import_no_jax(script):
    """The kernel probes run on the card's machine, which has no JAX."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        tree = ast.parse(f.read(), script)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN]


HYBRID_MODULES = ["tpugnn_torch.utils.native", "tpugnn_torch.baselines",
                  "tpugnn_torch.baselines.union_find", "tpugnn_torch.baselines.mwpm",
                  "tpugnn_torch.baselines.device_repair", "tpugnn_torch.eval.baseline",
                  "tpugnn_torch.eval.hybrid", "tpugnn_torch.serve.engine",
                  "tpugnn_torch.baselines.bp", "tpugnn_torch.baselines.osd",
                  "tpugnn_torch.tanner.spacetime", "tpugnn_torch.streaming",
                  "tpugnn_torch.streaming.window"]


@pytest.mark.parametrize("module", HYBRID_MODULES)
def test_hybrid_modules_import_without_jax(module):
    """Each module of the hybrid path imports where neither JAX, tpugnn nor
    networkx can be imported (the card's machine has none of them), and
    importing it builds nothing."""
    import subprocess
    import sys

    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpugnn', 'networkx'):\n"
            "    sys.modules[m] = None\n"
            f"import {module}\n"
            "from tpugnn_torch.utils import native\n"
            "assert native._LIB is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_detector_entry_points_need_cuda_unless_asked_for_cpu(no_cuda):
    """The detector-graph entry points default to the card and raise
    without one; with device='cpu' they run the plain path."""
    from tpugnn_torch.baselines import BPOSDDecoder
    from tpugnn_torch.eval import ler_bp, ler_bp_osd
    from tpugnn_torch.models.convert import DETECTOR_D5_WEIGHTS, STREAM_D5_WEIGHTS, load_decoder
    from tpugnn_torch.streaming import SlidingWindowDecoder
    from tpugnn_torch.tanner import build_code, build_spacetime_code

    g = build_code("surface", 3)
    gen = torch.Generator()
    for path in (DETECTOR_D5_WEIGHTS, STREAM_D5_WEIGHTS):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_decoder(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ler_bp(g, p=0.05, shots=1, batch=1, generator=gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ler_bp_osd(g, p=0.05, shots=1, batch=1, generator=gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BPOSDDecoder(g, p=0.05)
    _, model, graph = load_decoder(STREAM_D5_WEIGHTS, device="cpu")
    assert graph.name == build_spacetime_code("surface", 5, 5).name
    for adapter in ("from_gnn", "from_gnn_device", "from_gnn_cleanup"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(SlidingWindowDecoder, adapter)("surface", 5, window=5, commit=1,
                                                   model=model)
        getattr(SlidingWindowDecoder, adapter)("surface", 5, window=5, commit=1,
                                               model=model, device="cpu")
    assert ler_bp(g, p=0.05, shots=2, batch=2, generator=gen, device="cpu")["shots"] == 2.0
