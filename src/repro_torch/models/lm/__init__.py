"""The LM backbone of the port: so far the full / swa / rec + dense subset
that recurrentgemma-2b needs, with the RG-LRU scan as a CUDA kernel."""
