"""The port's CLI (tpugnn_torch.cli) end to end on tiny CPU configs, beside
the JAX package's (tests/test_cli.py): every subcommand with ``--cpu``, the
same JSON keys on stdout, the serve file round trip, spacetime and
circuit-level graphs, the refusals, and the bridge from a weights file."""

import json
import os

import numpy as np
import pytest

from tpugnn import cli as jax_cli
from tpugnn_torch import cli

TINY = ["--family", "repetition", "-d", "5", "--hidden", "8",
        "--msg-hidden", "8", "--rounds", "2", "--batch", "32",
        "--steps", "6", "--eval-every", "3", "--eval-shots", "64"]


def _rows(capsys, main, *argv) -> list[dict]:
    assert main(list(argv)) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(x) for x in out if x.startswith("{")]


def _run(capsys, *argv) -> list[dict]:
    return _rows(capsys, cli.main, *argv, "--cpu")


def test_train_eval_sweep_serve_roundtrip(tmp_path, capsys):
    ck = os.path.join(str(tmp_path), "ck")

    rows = _run(capsys, "train", *TINY, "--checkpoint-dir", ck, "--qubit-head", "pauli4")
    assert "loss" in rows[-1]

    rows = _run(capsys, "eval", *TINY, "--checkpoint-dir", ck,
                "--qubit-head", "pauli4", "--shots", "256")
    assert rows[-1]["d"] == 5 and "ler" in rows[-1]

    rows = _run(capsys, "sweep", *TINY, "--checkpoint-dir", ck,
                "--qubit-head", "pauli4", "--shots", "128",
                "--ps", "0.01", "0.05", "--baseline")
    assert [r["p"] for r in rows] == [0.01, 0.05]
    assert all("uf_ler" in r and "mwpm_ler" in r for r in rows)

    rows = _run(capsys, "serve", *TINY, "--checkpoint-dir", ck,
                "--qubit-head", "pauli4", "--max-batch", "32")
    assert rows[-1]["shots"] == 32 and rows[-1]["shots_per_s"] > 0

    syn = (np.random.default_rng(0).random((16, 4)) < 0.2).astype(np.uint8)
    inp = os.path.join(str(tmp_path), "syn.npy")
    outp = os.path.join(str(tmp_path), "corr.npy")
    np.save(inp, syn)
    rows = _run(capsys, "serve", *TINY, "--checkpoint-dir", ck,
                "--qubit-head", "pauli4", "--max-batch", "32",
                "--in", inp, "--out", outp)
    assert rows[-1]["out"] == outp
    corr = np.load(outp)
    assert corr.shape == (16, 5, 2) and corr.dtype == np.uint8
    # the default output file beside the input
    rows = _run(capsys, "serve", *TINY, "--checkpoint-dir", ck,
                "--qubit-head", "pauli4", "--max-batch", "8", "--in", inp,
                "--cleanup", "uf")
    assert rows[-1]["out"] == f"{inp}.corrections.npy"
    np.testing.assert_array_equal(np.load(rows[-1]["out"]).shape, (16, 5, 2))


@pytest.mark.parametrize("cmd,extra", [
    ("train", []),
    ("eval", ["--shots", "64", "--cleanup", "best_of"]),
    ("sweep", ["--shots", "64", "--ps", "0.02", "--baseline", "--cleanup", "mwpm"]),
    ("serve", ["--max-batch", "16"]),
])
def test_json_keys_equal_the_jax_cli(tmp_path, capsys, cmd, extra):
    """Both CLIs print the same JSON keys for the same flags (the port's
    checkpoint is its own, JAX's an orbax one, each from its own train)."""
    keys = []
    for main, suffix in ((cli.main, ["--cpu"]), (jax_cli.main, [])):
        ck = os.path.join(str(tmp_path), "cpu" if suffix else "jax")
        if cmd != "train":
            _rows(capsys, main, "train", *TINY, "--checkpoint-dir", ck, *suffix)
        rows = _rows(capsys, main, cmd, *TINY, "--checkpoint-dir", ck, *extra, *suffix)
        keys.append([sorted(r) for r in rows])
    assert keys[0] == keys[1]


def test_spacetime_flags(capsys):
    rows = _run(capsys, "train", "--family", "repetition", "-d", "3",
                "--hidden", "8", "--msg-hidden", "8", "--rounds", "2",
                "--batch", "32", "--steps", "4", "--eval-every", "4",
                "--eval-shots", "64", "--dt", "2")
    assert "loss" in rows[-1]


def test_circuit_flags(tmp_path, capsys):
    """--noise circuit --dt 3 --sector x trains, evaluates and serves on the
    circuit-level graph of the x sector."""
    ck = os.path.join(str(tmp_path), "ck")
    flags = ["--family", "surface", "-d", "3", "--hidden", "8", "--msg-hidden", "8",
             "--rounds", "2", "--batch", "32", "--steps", "4", "--eval-every", "4",
             "--eval-shots", "64", "--noise", "circuit", "--dt", "3", "--sector", "x",
             "--checkpoint-dir", ck, "-p", "0.01"]
    assert "loss" in _run(capsys, "train", *flags)[-1]
    row = _run(capsys, "eval", *flags, "--shots", "128", "--cleanup", "mwpm")[-1]
    assert {"ler", "ler_logical", "gnn_mwpm_ler"} <= set(row)
    row = _run(capsys, "serve", *flags, "--max-batch", "64")[-1]
    assert row["shots"] == 64


def test_weights_file_bridge(capsys):
    """--checkpoint-dir takes an exported weights file: the d=3 circuit
    weights evaluate on the graph the flags build, and a file of another
    model or graph is refused."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tpugnn_torch", "assets", "circuit_surface_d3_t3_h128_r8_ema24000.npz")
    flags = ["--noise", "circuit", "--dt", "3", "-d", "3", "--backend", "pallas",
             "--hidden", "128", "--msg-hidden", "128", "--rounds", "8", "--qubit-head",
             "bits", "-p", "0.01", "--checkpoint-dir", path]
    row = _run(capsys, "eval", *flags, "--shots", "512", "--cleanup", "mwpm")[-1]
    assert row["ler_logical"] < 0.1 and row["gnn_mwpm_ler"] < 0.1
    with pytest.raises(ValueError, match="graph"):
        cli.main(["eval", *flags, "--sector", "x", "--shots", "8", "--cpu"])
    with pytest.raises(ValueError, match="model"):
        cli.main(["eval", *flags, "--rounds", "4", "--shots", "8", "--cpu"])


def test_bad_family_rejected():
    with pytest.raises(SystemExit):
        cli.main(["train", "--family", "nope"])


def test_runs_on_the_card_unless_asked_for_the_cpu():
    """Without --cpu the CLI runs on the card, and raises where there is
    none; it does not fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", *TINY])


def test_module_entry_point():
    """python -m tpugnn_torch.cli runs main()."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "tpugnn_torch.cli", "--help"], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "train" in r.stdout and "serve" in r.stdout
