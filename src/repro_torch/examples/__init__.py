"""The port's counterparts of the reference's ``examples/``: run each with
``python -m repro_torch.examples.<name> [--device cpu]`` (on the card by
default).  On the CPU each runs the reference example's own shape on the
plain backend ("torch" for the reference's "jnp"), so its numbers can be
held against the reference's; on the card each takes the kernels."""
