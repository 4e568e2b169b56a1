"""Hand-written Hopper kernels of the LM substrate and their plain
versions: K3 ``coalesced_gather.gather_rows`` and K4 ``moe_gmm.gmm``.
Launch counts: ``_lib.launch_count("gather_rows_kernel")``,
``_lib.launch_count("gmm_kernel")``."""

from repro_torch.kernels._lib import KERNELS, launch_count, reset_launch_counts

__all__ = ["KERNELS", "launch_count", "reset_launch_counts"]
