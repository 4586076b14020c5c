"""The port stands alone: it imports neither JAX nor the JAX package, it
runs on the card unless asked for the CPU, and its kernel wrappers run the
plain version for CPU tensors."""
import ast
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import fused_round, ref, ssd_scan, swa_decode, \
    trust_agg, trust_score

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    assert len(PORT_FILES) > 20
    for path in PORT_FILES:
        for mod in _imported(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_walk_covers_every_package():
    """The import walk above reaches every subpackage of the port."""
    port = ROOT / "src" / "repro_torch"
    walked = {p.relative_to(port).parts[0] for p in PORT_FILES
              if port in p.parents}
    for pkg in ("serve", "net", "checkpoint", "examples", "core", "chain",
                "kernels", "models", "launch", "tools"):
        assert pkg in walked


# the JAX package's modules that the port copies verbatim, with ``repro.``
# renamed: (path under src/, the 1-based lines whose comment may differ)
VERBATIM = {
    "configs/base.py": (), "configs/paper_net.py": (),
    "configs/h2o_danube_1_8b.py": (), "configs/zamba2_7b.py": (),
    "configs/smollm_135m.py": (), "configs/yi_6b.py": (),
    "configs/qwen2_moe_a2_7b.py": (), "configs/olmoe_1b_7b.py": (),
    "configs/xlstm_1_3b.py": (), "configs/minicpm3_4b.py": (),
    "configs/whisper_base.py": (), "configs/chameleon_34b.py": (),
    "configs/registry.py": (),
    "data/datasets.py": (), "chain/contract.py": (), "chain/proofs.py": (),
    "chain/ledger.py": (847,),
    "core/async_sim.py": (), "core/reputation.py": (),
    "core/selection.py": (), "serve/__init__.py": (), "serve/client.py": (),
    "serve/server.py": (), "net/__init__.py": (), "net/sim.py": (),
    "net/fork_choice.py": (), "net/node.py": (),
}


@pytest.mark.parametrize("rel", sorted(VERBATIM))
def test_verbatim_copy_has_not_drifted(rel):
    """``sed 's/\\brepro\\./repro_torch./g'`` of the reference file equals
    the port's, line for line; on the listed lines only the code before
    the comment must."""
    ref = re.sub(r"\brepro\.", "repro_torch.",
                 (ROOT / "src" / "repro" / rel).read_text()).splitlines()
    port = (ROOT / "src" / "repro_torch" / rel).read_text().splitlines()
    assert len(ref) == len(port), rel
    differ = [i for i, (a, b) in enumerate(zip(ref, port), 1) if a != b]
    assert differ == list(VERBATIM[rel]), rel
    for i in differ:
        assert ref[i - 1].split("#")[0] == port[i - 1].split("#")[0], (rel, i)


def test_protocol_imports_with_jax_and_repro_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.core.protocol, repro_torch.convert, "
            "repro_torch.launch.serve, repro_torch.models.hybrid, "
            "repro_torch.models.ssm, repro_torch.kernels.ssd_scan, "
            "repro_torch.core.selection, repro_torch.serve, "
            "repro_torch.net, repro_torch.checkpoint.store, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.async_federation, "
            "repro_torch.examples.multi_task_federation, "
            "repro_torch.examples.poisoning_defense, "
            "repro_torch.examples.decentralized_network, "
            "repro_torch.examples.federated_llm, "
            "repro_torch.launch.train, repro_torch.launch.dryrun, "
            "repro_torch.launch.specs, repro_torch.launch.mesh, "
            "repro_torch.tools.dryrun_projection, "
            "repro_torch.tools.dryrun_round, "
            "repro_torch.configs.registry as R; "
            "[R.get_config(a) for a in R.ARCH_IDS + ['paper-net']]; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_run_on_cuda_unless_asked():
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fl_step import make_fl_round
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import serve
    args = (get_config("paper-net"), FederationConfig(), TrainConfig())
    archs = [get_smoke_config(a) for a in ("h2o-danube-1.8b", "zamba2-7b")]
    tiny = dict(batch=1, prompt_len=4, gen=2)
    if torch.cuda.is_available():
        proto = SDFLBProtocol(*args)
        assert proto.node.device.type == "cuda"
        proto.finalize()
        for cfg in archs:
            assert serve(cfg, **tiny).tokens.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SDFLBProtocol(*args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fl_round(*args)
    for cfg in archs:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve(cfg, **tiny)
    proto = SDFLBProtocol(*args, device="cpu")
    assert proto.node.device.type == "cpu"
    proto.finalize()
    for cfg in archs:
        assert serve(cfg, device="cpu", **tiny).tokens.device.type == "cpu"


def test_wrappers_on_cpu_return_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    u = torch.randn((5, 300), generator=gen)
    w, keep = torch.rand(5, generator=gen), (torch.rand(5) > 0.5).float()
    pending = torch.randn((5, 300), generator=gen)
    q, kc, vc = (torch.randn(s, generator=gen) for s in
                 ((2, 4, 8), (2, 30, 2, 8), (2, 30, 2, 8)))
    sq, sk, sv = (torch.randn(s, generator=gen) for s in
                  ((2, 32, 1, 8), (2, 32, 1, 8), (2, 32, 3, 4)))
    sq, sk = sq.expand(2, 32, 3, 8), sk.expand(2, 32, 3, 8)
    sa, si = -torch.rand((2, 32, 3), generator=gen), torch.rand((2, 32, 3))
    before = (trust_score.trust_score_stats.launches,
              trust_agg.trust_agg.launches,
              fused_round.fused_async_agg.launches,
              swa_decode.swa_decode.launches, ssd_scan.ssd_scan.launches)
    for g, e in zip(trust_score.trust_score_stats(u), ref.trust_score_ref(u)):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    torch.testing.assert_close(trust_agg.trust_agg(u, w),
                               ref.trust_agg_ref(u, w), rtol=0, atol=0)
    for g, e in zip(fused_round.fused_async_agg(u, pending, w, keep),
                    ref.fused_async_agg_ref(u, pending, w, keep)):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    torch.testing.assert_close(swa_decode.swa_decode(q, kc, vc, 20, 8),
                               ref.swa_decode_ref(q, kc, vc, 20, 8),
                               rtol=0, atol=0)
    for g, e in zip(ssd_scan.ssd_scan(sq, sk, sv, sa, si, chunk=16),
                    ref.ssd_scan_ref(sq, sk, sv, sa, si, chunk=16)):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    # the plain path launches nothing
    assert before == (trust_score.trust_score_stats.launches,
                      trust_agg.trust_agg.launches,
                      fused_round.fused_async_agg.launches,
                      swa_decode.swa_decode.launches,
                      ssd_scan.ssd_scan.launches)
