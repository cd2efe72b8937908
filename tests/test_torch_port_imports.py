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
    assert set(_build.SOURCES) == {"spmm", "sddmm", "roll_gather", "roll_gather_tf32",
                                  "wide_rounds", "wide_rounds_tf32", "wide_backward",
                                  "wide_backward_tf32"}
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("script", ["_probe_common.py", "k4_probe.py", "k5_probe.py",
                                    "smoke_turns.py", "ler_rows_card.py",
                                    "dist_startup_probe.py", "wide_bf16_steps.py",
                                    "split_compile_probe.py", "wide_probe.py",
                                    "k2b_wide_ties.py", "f32_k2a_seeds.py",
                                    "k1_precision_probe.py", "w128_levers.py"])
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


CIRCUIT_AND_CLI_MODULES = ["tpugnn_torch.tanner.circuit", "tpugnn_torch.cli",
                           "tpugnn_torch.utils.metrics", "tpugnn_torch.utils.timing",
                           "tpugnn_torch.utils.hostidle"]


@pytest.mark.parametrize("module", CIRCUIT_AND_CLI_MODULES)
def test_circuit_and_cli_modules_import_without_jax(module):
    """The circuit graphs, the CLI and the utils import where neither JAX
    nor tpugnn can be imported, and importing them builds nothing."""
    import subprocess
    import sys

    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpugnn', 'networkx'):\n"
            "    sys.modules[m] = None\n"
            f"import {module}\n"
            "from tpugnn_torch.kernels import _build\n"
            "assert _build.load_library.cache_info().currsize == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert os.path.join(REPO, *module.split(".")) + ".py" in _port_files()


def test_cli_and_generic_train_need_cuda_unless_asked_for_cpu(no_cuda, tmp_path):
    """The CLI and generic training default to the card and raise without
    one, before they build, sample or write anything."""
    from tpugnn_torch import cli
    from tpugnn_torch.configs import ExperimentConfig, ModelConfig, TrainConfig
    from tpugnn_torch.models.convert import load_decoder
    from tpugnn_torch.tanner import build_code
    from tpugnn_torch.train import init_state, train

    ck = str(tmp_path / "c")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "--steps", "1", "--checkpoint-dir", ck])
    cfg = ExperimentConfig(model=ModelConfig(backend="segment"),
                           train=TrainConfig(steps=1, checkpoint_dir=ck))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg, build_code("surface", 3))
    assert not (tmp_path / "c").exists()
    path = os.path.join(REPO, "tpugnn_torch", "assets",
                        "circuit_surface_d3_t3_h128_r8_ema24000.npz")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_decoder(path)


DIST_MODULES = ["tpugnn_torch.dist", "tpugnn_torch.dist.mesh", "tpugnn_torch.dist.partition",
                "tpugnn_torch.dist.exchange", "tpugnn_torch.dist.api",
                "tpugnn_torch.dist.multihost"]


@pytest.mark.parametrize("module", DIST_MODULES)
def test_dist_modules_import_without_jax(module):
    """The distributed modules import where neither JAX nor tpugnn can be
    imported, join no process group and build nothing."""
    import subprocess
    import sys

    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpugnn', 'networkx'):\n"
            "    sys.modules[m] = None\n"
            f"import {module}\n"
            "import torch.distributed as dist\n"
            "from tpugnn_torch.kernels import _build\n"
            "assert not dist.is_initialized()\n"
            "assert _build.load_library.cache_info().currsize == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    path = os.path.join(REPO, *module.split("."))
    assert (path + ".py" in _port_files()) or (os.path.join(path, "__init__.py")
                                               in _port_files())


def test_dist_entry_points_need_cuda_unless_asked_for_cpu(no_cuda):
    """dryrun, launch, initialize, the sharded apply and train step and the
    data-parallel engine default to the card and raise without one, before
    they start a rank or join a group."""
    import torch.distributed as dist

    from tpugnn_torch.configs import ExperimentConfig, ModelConfig
    from tpugnn_torch.dist import (build_partitioned_code, dryrun, make_sharded_apply,
                                   make_sharded_train_step)
    from tpugnn_torch.dist.multihost import initialize, launch
    from tpugnn_torch.models import GNNDecoder
    from tpugnn_torch.serve import DecodeEngine

    graph, pg = build_partitioned_code("surface", 3, 2)
    cfg = ExperimentConfig(model=ModelConfig(hidden=8, msg_hidden=8, rounds=2))
    model = GNNDecoder(cfg.model, k=graph.k)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch(print, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize("file:///nonexistent/store", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sharded_apply(model, None, pg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sharded_train_step(cfg, model, None, graph, pg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(cfg, model, graph, max_batch=8, data_parallel=2)
    assert not dist.is_initialized()
