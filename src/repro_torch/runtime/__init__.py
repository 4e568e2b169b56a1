from repro_torch.runtime import fault, straggler
