"""The ``examples/torch/`` scripts run on the CPU at smoke size: each is a
thin caller of the port's launchers and modules, with its JAX counterpart's
flags plus ``--device``. (Their card runs are the smoke's phase 20.)"""

import runpy
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size ops on one intra-op thread: the suite's parallel workers
    oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def main_of(name):
    return runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name=name)["main"]


def test_quickstart(capsys):
    res = main_of("quickstart")(["--device", "cpu", "--epochs", "3"])
    assert len(res.epoch_times_s) == 3 and 0.0 <= res.test_acc <= 1.0
    assert "cora: 2708 nodes" in capsys.readouterr().out


def test_serve_batched():
    out = main_of("serve_batched")(["--device", "cpu", "--batch", "2", "--prompt-len", "16",
                                    "--decode-steps", "3"])
    assert out["device"] == "cpu" and out["tokens_generated"] == 2 * (3 + 1)


def test_lm_pretrain(capsys):
    out = main_of("lm_pretrain")(["--device", "cpu", "--steps", "2", "--seq", "32",
                                  "--batch", "4"])
    assert out["device"] == "cpu" and out["first_loss"] > 0
    assert "loss moved:" in capsys.readouterr().out


def test_pipeline_parallel_gnn(capsys):
    out = main_of("pipeline_parallel_gnn")(["--device", "cpu", "--dataset", "karate",
                                            "--epochs", "2"])
    # halo batching is exact: the same accuracy as the full batch
    assert out["halo"]["val_acc"] == out["full"]["val_acc"]
    text = capsys.readouterr().out
    assert "compiled halo / zb-v" in text and "schedule matrix" in text


def test_scaling_larger_graphs(capsys):
    out = main_of("scaling_larger_graphs")(["--device", "cpu", "--dataset", "karate",
                                            "--num-nodes", "2048", "--chunks", "4",
                                            "--epochs", "1"])
    assert out["diff"] < 1e-5  # data_parallel=2 against the host fill-drain oracle
    assert "replicas split the chunks: False" in capsys.readouterr().out


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_of("quickstart")(["--epochs", "1"])
