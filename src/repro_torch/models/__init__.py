"""The dense-attention LMs: layers, attention (with the flash kernel), transformer, serve step."""
