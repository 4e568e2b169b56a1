"""Architecture configs of the port (see ``registry``)."""

from repro_torch.configs.registry import (get_config, list_archs,
                                         runnable_shapes)

__all__ = ["get_config", "list_archs", "runnable_shapes"]
