"""The LMs: layers, attention (with the flash kernel), the MoE FFN, the RG-LRU and SSD blocks, transformer, serve step."""
