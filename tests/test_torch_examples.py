"""The port's examples (``repro_torch.examples``) on the CPU: each
``main`` at reduced size (fewer rounds, events or ticks and smaller data;
the poisoning and network scenarios at their defaults, which the CPU runs
in seconds), with the checks each example's own output claims."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import (async_federation, decentralized_network,
                                  device_arg, multi_task_federation,
                                  poisoning_defense, quickstart)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(samples=256, eval_samples=64, device="cpu")


def test_quickstart(capsys):
    out = quickstart.main(rounds=4, batch=16, **SMALL)
    assert out["verified"]
    assert out["record"]["worker"] == 0 and out["record"]["round"] >= 0
    assert 0.0 <= out["metrics"]["accuracy"] <= 1.0
    assert set(out["payouts"]) == {"worker-0", "worker-1", "worker-2"}
    printed = capsys.readouterr().out
    assert "light-client audit" in printed and "ledger verified: True" \
        in printed


def test_async_federation(capsys):
    out = async_federation.main(events=10, batch=8, **SMALL)
    fast = out["records"]["fast"]
    assert len(fast) >= 10 > len(out["records"]["slow"])
    assert out["speedup"] > 1.0
    assert out["record"]["round"] == fast[-1].round_index
    assert "staleness" in out["record"]
    assert "chain deep-verified" in capsys.readouterr().out


def test_multi_task_federation():
    out = multi_task_federation.main(ticks=3, batch=8, **SMALL)
    assert out["verified"] and out["proof_ok"] and out["multi_blocks"] >= 2
    assert sorted(out["payouts"]) == ["bank-fl", "hospital-fl", "iot-fl"]


@pytest.mark.parametrize("head_level", [False, True], ids=["workers", "head"])
def test_poisoning_defense_penalises_the_attackers(head_level):
    out = poisoning_defense.main(head_level, device="cpu")
    stakes = out["defended"]["stakes"]
    attackers = out["attackers"]
    honest = [w for w in range(8) if w not in attackers]
    assert max(stakes[w] for w in attackers) < min(stakes[w] for w in honest)
    assert all(stakes[w] < 10.0 for w in attackers)
    for run in ("defended", "undefended"):
        assert 0.0 <= out[run]["acc"] <= 1.0


def test_decentralized_network(capsys):
    decentralized_network.main()
    assert capsys.readouterr().out.rstrip().endswith("all scenarios converged.")


def test_examples_need_the_card_or_an_explicit_cpu():
    assert device_arg(["--head", "--device", "cpu"]) == "cpu"
    assert device_arg(["--head"]) is None
    if torch.cuda.is_available():
        # round 0 settles before round 1's heads are drawn
        out = quickstart.main(rounds=2, batch=8, samples=64, eval_samples=16)
        assert out["verified"]
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(rounds=1)


def test_examples_run_as_modules():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.decentralized_network"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "fault-free convergence" in out.stdout
