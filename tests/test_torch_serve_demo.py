"""The port's serving demo (taper_tpu_torch/examples/serve_demo.py) at a
tiny size on the CPU: a byte LM of one layer trained for a few steps,
four prompts served four ways, every greedy path's tokens identical (the
demo asserts it)."""

import pathlib

import torch

from taper_tpu_torch.examples import serve_demo

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_serve_demo_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)                  # the corpus is the repo's
    torch.set_num_threads(2)
    out = serve_demo.main(["--device", "cpu", "--steps", "3",
                           "--max-new", "6", "--requests", "4",
                           "--dim", "32", "--depth", "1", "--heads", "2"])
    assert len(out["tokens"]) == 4
    assert all(len(t) == 6 and all(0 <= x < 256 for x in t)
               for t in out["tokens"])
    assert set(out["rates"]) == {"batched ragged generate",
                                 "ServingEngine (host loop)",
                                 "offline_serve"}
    assert len(out["turn2"]) == 9 + 6
    assert "identical greedy tokens" in capsys.readouterr().out
