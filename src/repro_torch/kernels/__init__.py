"""Hand-written Hopper kernels of the LM substrate and their plain
versions: K3 ``coalesced_gather.gather_rows``, K4 ``moe_gmm.gmm``, K5
``flash_attention.flash_attention`` and K6 ``ssd_scan.ssd_scan_kernel``.
Launch counts: ``launch_count(name)`` for each name of ``KERNELS``
(``gather_rows_kernel``, ``gmm_kernel``, ``flash_attention_kernel``,
``ssd_scan_kernel``)."""

from repro_torch.kernels._lib import KERNELS, launch_count, reset_launch_counts

__all__ = ["KERNELS", "launch_count", "reset_launch_counts"]
