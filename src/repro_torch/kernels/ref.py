"""The plain PyTorch versions of the port's kernels, under the name of the
reference package's oracle module (``repro.kernels.ref``). Each one lives
beside its kernel's wrapper; this module only gathers them."""
from repro_torch.kernels.fused_round import fused_async_agg_ref
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.kernels.swa_decode import swa_decode_ref
from repro_torch.kernels.trust_agg import trust_agg_ref
from repro_torch.kernels.trust_score import trust_score_ref

__all__ = ["fused_async_agg_ref", "ssd_scan_bwd_ref", "ssd_scan_ref",
           "swa_decode_ref", "trust_agg_ref", "trust_score_ref"]
