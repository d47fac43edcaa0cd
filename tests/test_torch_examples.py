"""The JAX package's four ``examples/`` scripts on the port
(``repro_torch/examples/``), run on the CPU at small sizes: each
finishes and prints what the reference's prints.  The FL examples
evaluate every 4 or 5 rounds, as the reference's, so their round counts
are multiples of that."""

import runpy
import sys

import pytest
import torch

from repro_torch.examples import (feddct_mnist, multi_arch_fl, quickstart,
                                  serve_decode)
from repro_torch.launch import serve

torch.set_num_threads(1)


def test_quickstart(capsys):
    results = quickstart.main(["--rounds", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert set(results) == {"feddct", "fedavg"}
    assert "== summary ==" in out and "faster in simulated wall-clock" in out


def test_feddct_mnist_saves_each_history(tmp_path, capsys):
    summary = feddct_mnist.main(["--rounds", "5", "--clients", "4",
                                 "--scale", "0.005", "--methods",
                                 "feddct,fedavg", "--out", str(tmp_path),
                                 "--device", "cpu"])
    assert [m for m, _, _ in summary] == ["feddct", "fedavg"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fedavg.json",
                                                          "feddct.json"]
    assert "method     best_acc   virtual_time" in capsys.readouterr().out


def test_multi_arch_fl(capsys):
    hists = multi_arch_fl.main(["--archs", "llama3.2-1b", "--rounds", "1",
                                "--device", "cpu"])
    assert len(hists["llama3.2-1b"].accuracy) == 1
    assert "llama3.2-1b    next-token acc" in capsys.readouterr().out


def test_serve_decode_is_the_serve_cli(monkeypatch, capsys):
    assert serve_decode.main is serve.main
    monkeypatch.setattr(sys, "argv", [
        "serve_decode", "--arch", "llama3.2-1b", "--batch", "2",
        "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    runpy.run_path(serve_decode.__file__, run_name="__main__")
    assert capsys.readouterr().out


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["--rounds", "1"])
