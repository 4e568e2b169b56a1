"""Model stack of the port: configs, layers, MoE dispatch, LM assembly."""
