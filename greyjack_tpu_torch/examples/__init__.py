"""Runnable examples of the port, the twins of the JAX package's
`examples/`: `python -m greyjack_tpu_torch.examples.<name> [--device cpu]`.
They run on the card unless `--device` names another."""
