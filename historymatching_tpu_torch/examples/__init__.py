"""The tutorial workflows on the port, run as
`python -m historymatching_tpu_torch.examples.<name>`."""
