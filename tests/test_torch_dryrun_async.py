"""The dry run over the smoke config of every family's async round at
W = 4 (the per-leaf path: the pending buffers and the staleness
discounts), traced once on fake tensors on the CPU and checked as
``tests/test_torch_dryrun_steps.py`` checks its rounds."""
import pytest

from test_torch_dryrun_steps import FAMILIES, run_round


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_async_round(family):
    run_round(family, "async")
