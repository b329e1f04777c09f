"""The benchmark of the PyTorch/CUDA port (`normalizingflow_tpu_torch`):
`python3 -m nfbench.run`; see nfbench/README.md."""
