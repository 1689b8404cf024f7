"""The model stack: layers and the config-driven transformer (dense
decoders in this slice)."""
