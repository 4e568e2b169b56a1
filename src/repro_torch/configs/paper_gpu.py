"""The paper's GPU baseline (Table 1) for the warp-size study."""

from repro_torch.core.warpsim.config import MachineConfig

TABLE1 = MachineConfig(
    name="paper-baseline", warp_size=32, simd_width=8,
    num_sms=2,            # scaled from 16 (homogeneous; bandwidth scaled)
    threads_per_sm=1024, pipeline_depth=24,
    num_mem_ctrls=6, dram_bw_gbps=76.8,
)
