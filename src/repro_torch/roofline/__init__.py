from repro_torch.roofline import op_analysis, report
