"""Command-line apps (sample_data / train / test / fe / polymer), run as
`python -m normalizingflow_tpu_torch.apps.<name> <config.yaml> ...` with the
JAX package's arguments. They run on the config's device (`device: cpu`
for the CPU, the card otherwise) and write checkpoints as `{name}.pt`."""
