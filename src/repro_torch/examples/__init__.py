"""The reference's examples on the port (``examples/*.py`` of the repo
root are the JAX package's). Run one with
``PYTHONPATH=src python -m repro_torch.examples.<name>`` — on the card,
or with ``--device cpu`` on the CPU. The six: ``quickstart``,
``async_federation``, ``multi_task_federation``, ``poisoning_defense``,
``decentralized_network`` and ``federated_llm`` (the same protocol over a
dense LLM, ``--arch``). Each ``main`` takes the sizes as keyword arguments
(defaults: the reference example's) and ``device``."""
from __future__ import annotations

import sys
from typing import Optional, Sequence


def device_arg(argv: Optional[Sequence[str]] = None) -> Optional[str]:
    """The value of ``--device`` on the command line (None: the card)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        return argv[argv.index("--device") + 1]
    return None
