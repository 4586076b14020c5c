"""The dry run over the smoke config of every family's round at W = 4 on
the flat pack (``fused_trust_path="on"``): a sync round, which runs K1 and
K2, and an async one, which runs K1 and K3, each traced once on fake
tensors on the CPU and checked as ``tests/test_torch_dryrun_steps.py``
checks its rounds (in f32 where the family's bf16 params mix dtypes and
so admit no pack)."""
import pytest

from test_torch_dryrun_steps import FAMILIES, run_round


@pytest.mark.parametrize("mode", ["flat_sync", "flat_async"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flat_round(family, mode):
    run_round(family, mode)
